"""Fleet sweep CLI: run a grid manifest end to end, resumably.

    PYTHONPATH=src python -m repro_torch.fleet.run grid.json
    PYTHONPATH=src python -m repro_torch.fleet.run grid.json --device cpu
    PYTHONPATH=src python -m repro_torch.fleet.run grid.json --dry-run
    PYTHONPATH=src python -m repro_torch.fleet.run grid.json --query 0.8
    PYTHONPATH=src python -m repro_torch.fleet.run grid.json --base-dir /tmp/s

Counterpart of ``repro/fleet/run.py`` (runs on ``cuda`` unless
``--device cpu``).  Expands the grid, prints the class plan, executes
every pending cell into ``<base-dir>/<grid-hash>/`` (completed cells are
skipped: re-invoking on a finished grid performs zero runs), and prints
the per-class report.  ``--query ACC`` also renders the seed-averaged
time/energy-to-accuracy table from the store.  Inspect a sweep directory
later with ``python -m repro_torch.obs.report <dir>``.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.fleet.run",
        description="Run a SweepGrid manifest with setup and contact-plan "
                    "sharing classes and resumable persisted results.")
    ap.add_argument("grid_json", help="SweepGrid manifest (the schema of "
                                      "repro_torch/fleet/grid.py)")
    ap.add_argument("--base-dir", default="results/sweeps",
                    help="sweep store root (default: results/sweeps)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--dry-run", action="store_true",
                    help="print the expansion + class plan and exit "
                         "without running anything")
    ap.add_argument("--query", type=float, metavar="ACC", default=None,
                    help="after the run, print the time/energy-to-ACC "
                         "table (seed-averaged)")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch.fleet.grid import SweepGrid
    from repro_torch.fleet.plan import plan_grid
    grid = SweepGrid.load(args.grid_json)

    if args.dry_run:
        plan = plan_grid(grid)
        print(f"[fleet] grid {grid.name!r} hash={grid.grid_hash()}")
        print(plan.summary())
        return 0

    from repro_torch.fleet.exec import run_grid
    store, _ = run_grid(grid, args.base_dir, device=args.device,
                        verbose=not args.quiet)
    if args.query is not None:
        from repro_torch.fleet.store import SweepStore
        rows = store.query(target_acc=args.query)
        print(f"\n-- time/energy to acc>={args.query} "
              f"(seed-averaged) --")
        print(SweepStore.format_table(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
