"""Fleet smoke: class-sharing gate + resume gate + per-round gate.

    PYTHONPATH=src python -m repro_torch.fleet.smoke
    PYTHONPATH=src python -m repro_torch.fleet.smoke --update   # baseline
    PYTHONPATH=src python -m repro_torch.fleet.smoke --device cpu

Counterpart of ``repro/fleet/smoke.py`` (runs on ``cuda`` unless
``--device cpu``).  Runs a small grid (by default :data:`SMOKE_GRID`:
the reference's ``benchmarks/grids/fleet_smoke.json`` with the gated
fedspace added, 12 cells in 3 classes) into a TEMP directory and fails
(exit 2) unless:

(a) **sharing matches the classes**: contact plans are built once per
    gated ``vmap`` class (and once per setup of a gated ``loop`` class),
    never per cell, and setups miss the shared cache once per setup
    class of the ``loop`` cells, measured through
    ``repro_torch.obs.trace.COUNTERS`` (``engine.plan_cache.miss``,
    ``api.setup_cache.miss``);
(b) **resume is a no-op**: re-invoking on the same directory runs no
    cell and builds no setup or plan;
(c) **per-round wall** of each class stays within 2x of the baseline
    (``results/fleet_smoke_torch.json``), the port's own, measured on the
    card and stored with the card's name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them.  The gate refuses a baseline recorded on another card,
    and on the CPU it is not applied: a CPU time is no baseline.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from typing import Dict, List, Optional

BASELINE_PATH = "results/fleet_smoke_torch.json"

# the reference's benchmarks/grids/fleet_smoke.json, plus fedspace so a
# class shares a contact plan
SMOKE_GRID = {
    "name": "fleet-smoke-torch",
    "base": {"data.eval_size": 128, "data.samples_per_client": 32,
             "fleet.num_clients": 16, "fleet.num_clusters": 3,
             "train.batch_size": 16, "train.eval_every": 3,
             "train.local_steps": 1, "train.rounds": 6},
    "axes": [{"path": "method", "values": ["h-base", "fedce", "fedspace"]},
             {"path": "seed", "values": [0, 1, 2, 3]}],
}


def card_identity() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def expected_sharing(plan) -> Dict[str, int]:
    """Setup-cache misses and plan builds a cold run of ``plan`` makes
    when every class shares what it can: one plan per gated vmap class,
    one setup (and, gated, one plan) per setup key of the loop jobs."""
    from repro_torch.fleet.plan import setup_key
    plans, setups = 0, set()
    for cls in plan.classes:
        gated = next(iter(cls.jobs.values())).strategy.visibility_gated
        if cls.mode == "vmap":
            plans += gated
            continue
        new = {setup_key(sc) for sc in cls.jobs.values()} - setups
        setups |= new
        plans += gated * len(new)
    return {"engine.plan_cache.miss": plans,
            "api.setup_cache.miss": len(setups)}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.fleet.smoke")
    ap.add_argument("--grid", default=None,
                    help="grid JSON (default: the built-in SMOKE_GRID)")
    ap.add_argument("--baseline", default=BASELINE_PATH)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--update", action="store_true",
                    help="write the measured per-round times as the new "
                         "baseline (on the card) instead of gating")
    args = ap.parse_args(argv)

    from repro_torch import device as device_lib
    from repro_torch.fleet.exec import run_grid
    from repro_torch.fleet.grid import SweepGrid
    from repro_torch.fleet.plan import plan_grid
    from repro_torch.obs.trace import COUNTERS, Counters

    on_card = device_lib.resolve(args.device).type == "cuda"
    grid = (SweepGrid.load(args.grid) if args.grid
            else SweepGrid.from_dict(SMOKE_GRID))
    plan = plan_grid(grid)
    n_cells, n_classes = len(plan.cells), len(plan.classes)
    want = expected_sharing(plan)
    print(f"[fleet-smoke] grid {grid.name!r}: {n_cells} cells, "
          f"{n_classes} classes, expected {want}")

    failures: List[str] = []
    with tempfile.TemporaryDirectory(prefix="fleet-smoke-") as tmp:
        c0 = COUNTERS.snapshot()
        store, report = run_grid(grid, tmp, device=args.device,
                                 verbose=False)
        d1 = Counters.delta(c0, COUNTERS.snapshot())
        got = {k: d1.get(k, 0) for k in want}
        print(f"[fleet-smoke] cold run: {report['cells_run']} cells, "
              f"{got}, {report['wall_s']:.1f}s")
        if report["cells_run"] != n_cells:
            failures.append(f"cold run completed {report['cells_run']} of "
                            f"{n_cells} cells")
        if got != want:
            failures.append(f"sharing {got} != what the classes share "
                            f"{want}")

        # ---- resume gate: second invocation is a no-op -----------------
        c1 = COUNTERS.snapshot()
        _, report2 = run_grid(grid, tmp, device=args.device, verbose=False)
        d2 = Counters.delta(c1, COUNTERS.snapshot())
        redo = {k: v for k, v in d2.items() if "cache.miss" in k}
        print(f"[fleet-smoke] resume: {report2['cells_run']} run / "
              f"{report2['cells_skipped']} skipped, {redo or 'no'} misses")
        if report2["cells_run"] != 0 or report2["cells_skipped"] != n_cells:
            failures.append(
                f"resume ran {report2['cells_run']} cells "
                f"(skipped {report2['cells_skipped']}): expected a no-op")
        if redo:
            failures.append(f"resume set up again: {redo}")

        # ---- per-round timing gate vs the port's baseline --------------
        measured = {e["label"]: e["per_round_s"]
                    for e in report["classes"] if e.get("run")}
        card = card_identity() if on_card else None
        if args.update:
            if not on_card:
                failures.append("--update needs the card: a CPU time is "
                                "no baseline")
            else:
                parent = os.path.dirname(args.baseline)
                if parent:
                    os.makedirs(parent, exist_ok=True)
                with open(args.baseline, "w") as f:
                    json.dump({"device": card,
                               "grid_hash": grid.grid_hash(),
                               "classes": {k: {"per_round_s": v}
                                           for k, v in measured.items()}},
                              f, indent=2)
                print(f"[fleet-smoke] baseline for {card} written: "
                      f"{args.baseline}")
        elif not on_card:
            print("[fleet-smoke] per-round gate not applied on the CPU "
                  "(the baseline is the card's)")
        elif not os.path.exists(args.baseline):
            failures.append(f"no baseline at {args.baseline}; run with "
                            f"--update on the card")
        else:
            with open(args.baseline) as f:
                committed = json.load(f)
            if committed.get("device") != card:
                failures.append(
                    f"baseline recorded on {committed.get('device')!r}, "
                    f"this is {card!r}: not compared (run --update here)")
            elif committed.get("grid_hash") != grid.grid_hash():
                failures.append("baseline is for another grid")
            else:
                for label, per_round in measured.items():
                    base = committed["classes"].get(label, {}).get(
                        "per_round_s")
                    if base is None:
                        failures.append(f"class {label!r} missing from "
                                        f"the baseline (run --update)")
                    elif per_round > 2.0 * base:
                        failures.append(
                            f"class {label!r}: {per_round * 1e3:.1f} "
                            f"ms/round > 2x baseline {base * 1e3:.1f}")
                    else:
                        print(f"[fleet-smoke] {label}: "
                              f"{per_round * 1e3:.1f} ms/round (baseline "
                              f"{base * 1e3:.1f} on {card}, <=2x OK)")

    if failures:
        for f_ in failures:
            print(f"[fleet-smoke] FAIL: {f_}")
        return 2
    print("[fleet-smoke] OK: sharing per class, resume no-op"
          + (", per-round within 2x of the baseline" if on_card else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
