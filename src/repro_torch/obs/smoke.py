"""Telemetry smoke: the observability invariant, end to end.

    PYTHONPATH=src python -m repro_torch.obs.smoke --out telemetry-trace.json
    PYTHONPATH=src python -m repro_torch.obs.smoke --device cpu

Counterpart of ``repro/obs/smoke.py`` (runs on ``cuda`` unless
``--device cpu``).  Runs a tiny scenario (one sync, one async), kernels
on, with telemetry off and on, sharing one setup cache so the data and
fleet are identical, and exits nonzero on any violation of:

1. **Identical trajectories.**  Telemetry may add outputs; it must never
   change the training trajectory.  ``to_history()`` dicts are compared
   with ``==`` (exact float equality), and the engine's host reads and
   the kernel launches must be equal on and off.
2. **Bounded overhead.**  ``run_s`` (min over repeats taken in turns, so
   scheduler noise does not flake the gate) with telemetry on must be within
   ``--max-overhead`` (default 10%) of off, failing only when the excess
   is also over 10 ms (the reference's grace floor: a tiny round takes
   milliseconds).
3. **Valid trace artifact.**  The Chrome trace-event JSON written to
   ``--out`` must load and pass :func:`repro_torch.obs.telemetry
   .load_chrome_trace`.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional


def _scenarios():
    from repro_torch.core.fedhc import FLRunConfig
    from repro_torch.core.scenario import ExecSpec, Scenario

    tiny = dict(num_clients=12, num_clusters=2, rounds=6, eval_every=3,
                samples_per_client=16, local_steps=1, batch_size=8,
                eval_size=64, seed=7)
    sync = Scenario.from_flat(FLRunConfig(method="fedhc", **tiny))
    asyn = Scenario.from_flat(FLRunConfig(
        method="fedhc-async", async_cohort=4, async_buffer=3, **tiny))
    out = []
    for sc in (sync, asyn):
        off = sc.replace(exec=ExecSpec(telemetry=False,
                                       use_pallas_kernels=True))
        on = sc.replace(exec=ExecSpec(telemetry=True,
                                      use_pallas_kernels=True))
        out.append((sc.method, off, on))
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.smoke",
        description="Gate: telemetry on/off parity + overhead.")
    ap.add_argument("--out", default=None, metavar="TRACE.json",
                    help="write the telemetry-on Chrome trace here")
    ap.add_argument("--max-overhead", type=float, default=0.10,
                    help="max fractional run_s overhead telemetry-on vs "
                         "off (default 0.10)")
    ap.add_argument("--repeats", type=int, default=3,
                    help="timing repeats; min is compared (default 3)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch import api
    from repro_torch.core import engine
    from repro_torch.kernels import ops
    from repro_torch.obs.telemetry import load_chrome_trace

    def counted(sc, cache):
        engine.reset_host_reads()
        ops.reset_launches()
        res = api.run(sc, device=args.device, setup_cache=cache)
        return res, (dict(engine.HOST_READS), dict(ops.LAUNCHES))

    failures = []
    last_on = None
    for name, sc_off, sc_on in _scenarios():
        cache = {}
        # warm the kernel build and the shared setup before timing
        res_off, work_off = counted(sc_off, cache)
        res_on, work_on = counted(sc_on, cache)
        last_on = res_on

        ident = res_off.to_history() == res_on.to_history()
        print(f"[{name}] identical trajectory: {ident}"
              f"  (final acc {res_on.final_acc:.3f})")
        if not ident:
            failures.append(f"{name}: telemetry ON changed the trajectory")
        print(f"[{name}] host reads, launches: off {work_off} on {work_on}")
        if work_on != work_off:
            failures.append(f"{name}: telemetry ON changed the host reads "
                            f"or kernel launches")

        t = res_on.telemetry
        if t is None or t.num_rounds == 0:
            failures.append(f"{name}: telemetry ON but no round series")
        else:
            print(f"[{name}] {t.summary()}")

        times = {sc_off: [], sc_on: []}
        for _ in range(args.repeats):            # in turns: off, on
            for sc in times:
                times[sc].append(api.run(sc, device=args.device,
                                         setup_cache=cache).run_s)
        t_off, t_on = min(times[sc_off]), min(times[sc_on])
        overhead = (t_on - t_off) / max(t_off, 1e-9)
        visible = (t_on - t_off) > 0.010
        print(f"[{name}] run_s off={t_off:.4f} on={t_on:.4f} "
              f"overhead={overhead * 100:+.1f}% ({args.device})")
        if overhead > args.max_overhead and visible:
            failures.append(
                f"{name}: telemetry overhead {overhead * 100:.1f}% "
                f"> {args.max_overhead * 100:.0f}%")

    if args.out and last_on is not None and last_on.telemetry is not None:
        last_on.telemetry.save_chrome_trace(args.out)
        try:
            trace = load_chrome_trace(args.out)
            print(f"trace artifact: {args.out} "
                  f"({len(trace['traceEvents'])} trace events): valid")
        except ValueError as e:
            failures.append(f"trace artifact invalid: {e}")

    if failures:
        print("\nSMOKE FAILED:", file=sys.stderr)
        for f in failures:
            print(f"  - {f}", file=sys.stderr)
        return 1
    print("\ntelemetry smoke OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
