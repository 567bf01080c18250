"""Run-report CLI: render a saved ``RunResult`` JSON.

    PYTHONPATH=src python -m repro_torch.obs.report results/run.json
    PYTHONPATH=src python -m repro_torch.obs.report run.json --trace t.json
    PYTHONPATH=src python -m repro_torch.obs.report run.json --rows 12
    PYTHONPATH=src python -m repro_torch.obs.report results/sweeps/<hash>/

Counterpart of ``repro/obs/report.py``.  A run file or sweep directory
written by either package renders the same way: both write the same JSON.

Prints the run header (method / strategy axes / final accuracy / totals),
the host phase-time breakdown (setup / compile / run / fetch spans +
cache counters), and, when the run was recorded with
``ExecSpec.telemetry`` on, a round-by-round device-plane table: cohort
composition, buffer occupancy, staleness spread, per-stage traffic, the
compute/comm energy split, and ISL hop counts.  ``--trace`` additionally
exports the Chrome trace-event JSON (open in https://ui.perfetto.dev).

Pointing it at a **sweep directory** (one written by
``python -m repro_torch.fleet.run`` or ``python -m repro.fleet.run``,
identified by its ``grid.json``) instead renders the fleet view: grid
header, per-class table with the COUNTERS cache deltas recorded at
execution time, completion state, and the per-cell final-accuracy
summary grouped over seeds.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

import numpy as np


def _round_table(rounds, num_rows: int) -> List[str]:
    n = 0
    for v in rounds.values():
        n = int(np.asarray(v).shape[0])
        break
    head = (" round |   dt_s | cohort | accept | buf(mean/max) | "
            "stale(mn/av/mx) | fl | gl | rc | MB s1 | MB s2 | "
            "E_cmp_J | E_comm_J | hops(av/mx)")
    lines = [head, "-" * len(head)]
    if num_rows and n > num_rows:
        # head + tail around an ellipsis row
        idx = list(range(num_rows // 2)) + [None] + \
            list(range(n - (num_rows - num_rows // 2), n))
    else:
        idx = list(range(n))
    g = {k: np.asarray(v) for k, v in rounds.items()}
    for i in idx:
        if i is None:
            lines.append(f"  ...  | ({n - num_rows} more rounds)")
            continue
        buf = np.asarray(g["cluster_fill"][i], np.float64)
        lines.append(
            f"{i + 1:6d} |{g['t_round_s'][i]:7.1f} |"
            f"{int(g['cohort_size'][i]):7d} |{int(g['accepted'][i]):7d} |"
            f" {buf.mean():5.1f} /{buf.max():5.1f} |"
            f"  {g['stale_min'][i]:4.1f}/{g['stale_mean'][i]:4.1f}"
            f"/{g['stale_max'][i]:4.1f} |"
            f"{int(g['flushes'][i]):3d} |{int(g['did_global'][i]):3d} |"
            f"{int(g['reclustered'][i]):3d} |"
            f"{g['bits_stage1'][i] / 8e6:6.2f} |"
            f"{g['bits_stage2'][i] / 8e6:6.2f} |"
            f"{g['e_compute_j'][i]:8.2f} |{g['e_comm_j'][i]:9.2f} |"
            f"  {g['hops_mean'][i]:4.1f}/{g['hops_max'][i]:4.1f}")
    return lines


def render(res, num_rows: int = 20) -> str:
    """The full text report for a loaded RunResult."""
    s = res.strategy
    out = []
    out.append(f"== run report: {s.get('name', res.scenario.method)} ==")
    out.append(
        f"strategy: connectivity={s.get('connectivity')} "
        f"aggregation={s.get('aggregation')} "
        f"recluster={s.get('recluster', s.get('reclusters'))} "
        f"mesh={res.mesh_shape}")
    out.append(
        f"trajectory: {len(res.round)} eval points over "
        f"{int(res.round[-1])} rounds | final acc {res.final_acc:.3f} | "
        f"T={res.time_s[-1]:.0f}s E={res.energy_j[-1]:.1f}J | "
        f"reclusters={res.reclusters} globals={res.global_rounds}")
    mem = []
    if res.peak_device_mem_mb is not None:
        mem.append(f"device {res.peak_device_mem_mb:.1f} MB")
    if res.peak_host_mem_mb is not None:
        mem.append(f"host RSS {res.peak_host_mem_mb:.1f} MB")
    out.append(f"peak memory: {', '.join(mem) if mem else 'unavailable'}")

    out.append("")
    out.append("-- phase breakdown (host wall clock) --")
    out.append(f"  setup   {res.setup_s:8.3f}s")
    out.append(f"  compile {res.compile_s:8.3f}s")
    out.append(f"  run     {res.run_s:8.3f}s")
    out.append(f"  total   {res.wall_s:8.3f}s")
    t = res.telemetry
    if t is not None and t.spans:
        out.append("  spans:")
        for sp in t.spans:
            out.append(f"    {'  ' * sp.get('depth', 0)}{sp['name']:<12} "
                       f"{sp['dur_us'] / 1e6:8.3f}s")
    if t is not None and t.counters:
        out.append("  counters: " + ", ".join(
            f"{k}={v}" for k, v in sorted(t.counters.items())))

    out.append("")
    if t is None or not t.rounds:
        out.append("(no device-plane telemetry in this run: record with "
                   "ExecSpec(telemetry=True) for the round table)")
    else:
        out.append(f"-- device plane: {t.num_rounds} rounds --")
        out.extend(_round_table(t.rounds, num_rows))
        out.append("")
        out.append(t.summary())
    return "\n".join(out)


def render_sweep(root: str) -> str:
    """The fleet view for a sweep directory written by either package's
    fleet.

    Shows the grid identity, the per-class execution report (mode,
    cell counts, wall/per-round time, and the cache COUNTERS deltas
    captured while the class ran), and a seed-grouped final-accuracy
    summary over the persisted cells.
    """
    from repro_torch.fleet.store import SweepStore
    store = SweepStore.open_dir(root)
    grid = store.grid()
    done = store.completed()
    out = []
    out.append(f"== sweep report: {grid.name} ==")
    out.append(f"dir: {store.root}  grid-hash: {grid.grid_hash()}")
    out.append(f"cells: {len(done)} completed of {len(grid.cells())}")

    report = store.read_report()
    out.append("")
    if report is None:
        out.append("(no report.json yet: run "
                   "`python -m repro_torch.fleet.run <grid.json>` to "
                   "execute)")
    else:
        out.append(f"-- last invocation: {report['cells_run']} run / "
                   f"{report['cells_skipped']} skipped in "
                   f"{report['wall_s']:.1f}s --")
        head = (" class                                    | mode | cells"
                " | run |   wall_s | ms/round | cache counters")
        out.append(head)
        out.append("-" * len(head))
        for e in report["classes"]:
            ctr = ", ".join(f"{k.split('.', 1)[1]}={v}"
                            for k, v in sorted(e.get("counters", {}).items())
                            if "cache" in k) or "-"
            wall = f"{e['wall_s']:9.2f}" if "wall_s" in e else "        -"
            pr = (f"{e['per_round_s'] * 1e3:9.1f}"
                  if "per_round_s" in e else "        -")
            out.append(f" {e['step_key']:<41}| {e['mode']:<5}|"
                       f"{e['cells']:6d} |{e['run']:4d} |{wall} |{pr} "
                       f"| {ctr}")

    if done:
        out.append("")
        out.append("-- final accuracy (grouped over seeds) --")
        for gk, results in sorted(store.grouped().items()):
            sc = results[0].scenario
            accs = [r.final_acc for r in results]
            label = (f"{sc.method} N={sc.fleet.num_clients} "
                     f"K={sc.fleet.num_clusters} {sc.data.dataset.name}")
            out.append(f"  {label:<48} "
                       f"acc {float(np.mean(accs)):.3f}"
                       f" +/- {float(np.std(accs)):.3f}  "
                       f"({len(results)} cells)")
    return "\n".join(out)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Render a saved RunResult JSON (round table, "
                    "phase-time breakdown, Perfetto trace export) or a "
                    "fleet sweep directory (per-class cache counters).")
    ap.add_argument("run_json", help="path written by RunResult.save(), "
                                     "or a fleet sweep directory")
    ap.add_argument("--rows", type=int, default=20,
                    help="max round-table rows (head+tail; default 20)")
    ap.add_argument("--trace", metavar="OUT.json", default=None,
                    help="also export Chrome trace-event JSON "
                         "(load in https://ui.perfetto.dev)")
    args = ap.parse_args(argv)

    if os.path.isdir(args.run_json):
        if not os.path.exists(os.path.join(args.run_json, "grid.json")):
            print(f"{args.run_json} is a directory without a grid.json — "
                  f"not a sweep store", file=sys.stderr)
            return 2
        print(render_sweep(args.run_json))
        return 0

    from repro_torch.api import RunResult
    res = RunResult.load(args.run_json)
    print(render(res, num_rows=args.rows))
    if args.trace:
        if res.telemetry is None:
            print(f"\nno telemetry recorded — cannot export {args.trace}",
                  file=sys.stderr)
            return 2
        res.telemetry.save_chrome_trace(args.trace)
        print(f"\nChrome trace-event JSON written to {args.trace} "
              f"(open in https://ui.perfetto.dev)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
