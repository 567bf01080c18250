"""Readings from which a cell's limits are set (not run by the benchmark).

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control] [--out chiprun_out/readings.jsonl]

For each seed, in one process: the cell's set-up, its window's units up
to the compared one, and the compared numbers of the program against
the plain reference ("program"); with ``--control`` also those of the
control, the reference computed one precision below the configuration's
and put in the program's place ("control").  A driver that checks step
by step (``stepwise``) gives both sides' step readings from one more
run of the program.  A limit lies above every program reading and
below every control reading.
"""
from __future__ import annotations

import json
import sys
import time

import run as harness


def _loss_gaps(prog: dict, ref: dict) -> list:
    """Per-round relative loss gaps, where both answers have a history."""
    if "history" not in prog or "history" not in ref:
        return []
    return [abs(p - r) / abs(r)
            for p, r in zip(prog["history"]["loss"], ref["history"]["loss"])]


def readings(workload: str, seed: int, control: bool, device: str = "cuda",
             cell_patch=None, traffic=None, fault: str = "") -> dict:
    """One seed's readings; ``fault`` names a fault of `faults.py` to
    plant in the program for the run (its readings are then the fault's,
    under "program")."""
    harness._environment()
    import faults
    patch = faults.Patch()
    try:
        if fault:
            getattr(faults, fault)(patch)
        return _readings(workload, seed, control, device, cell_patch,
                         traffic, fault)
    finally:
        patch.undo()


def _readings(workload, seed, control, device, cell_patch, traffic, fault):
    import torch
    from pb import manifest
    cell = manifest.cell_file(workload)
    config = manifest.config_file(cell["config"])
    if cell_patch is not None:
        cell_patch(cell, config)
    cell["traffic"].update(traffic or {})
    drv = manifest.load_module("drivers", cell["driver"]).Driver(
        cell, config, seed, torch.device(device), False)
    t0 = time.perf_counter()
    drv.setup()
    drv.start_window()
    while not drv.compared_unit_done():
        drv.run_unit()
    drv.release()
    t1 = time.perf_counter()
    stepwise = getattr(drv, "stepwise", None)
    steps = stepwise(control) if stepwise else {}
    t_steps = time.perf_counter()
    prog = drv.program_answer()
    ref = drv.reference_answer(prog)
    t2 = time.perf_counter()
    out = {"workload": workload, "seed": seed, "fault": fault,
           "program": {**steps.get("program", {}),
                       **drv.readings(prog, ref)},
           "stepwise_s": t_steps - t1,
           "setup_and_units_s": t1 - t0, "reference_s": t2 - t_steps,
           "program_loss_gaps": _loss_gaps(prog, ref)}
    if control:
        ctrl = drv.control_answer(prog)
        out["control"] = {**steps.get("control", {}),
                          **drv.readings(ctrl, ref)}
        out["control_loss_gaps"] = _loss_gaps(ctrl, ref)
        if hasattr(drv, "leaf_detail"):
            out["leaves"] = drv.leaf_detail(prog, ref, ctrl)
    if "losses" in ref:
        out["losses"] = {"program": prog["losses"], "reference": ref["losses"],
                         **({"control": ctrl["losses"]} if control else {})}
    del drv, prog, ref
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--out", default="")
    ap.add_argument("--traffic", default="{}",
                    help="JSON of traffic parameters to override")
    ap.add_argument("--fault", default="",
                    help="a fault of perfbench/faults.py to plant")
    args = ap.parse_args(argv)
    rows = []
    for s in args.seeds.split(","):
        row = readings(args.workload, int(s), args.control,
                       traffic=json.loads(args.traffic), fault=args.fault)
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    for group in ("program", "control"):
        keys = rows[0].get(group, {})
        for k in keys:
            vals = [r[group][k] for r in rows]
            print(f"{group} {k}: min {min(vals)!r} max {max(vals)!r}",
                  file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
