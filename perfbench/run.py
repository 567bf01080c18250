"""The benchmark of the PyTorch and CUDA port (`repro_torch`).

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

runs one cell of ``BENCHMARK.json`` on the card it is started on and
prints one JSON line last on standard output.  Set-up (process start,
imports, the CUDA context, the kernels from the build cache, the cell's
own set-up and a warm-up of its shapes) is ``setup_s``; the window then
runs whole units of work back to back (a closed loop) until ``--seconds``
are spent.  With ``--trace 1`` a second, shorter window (the cell's
``trace_seconds``) runs under ``torch.profiler`` after it, and the line
holds the cell's per-layer metrics instead of its end-to-end ones.  After the window the compared unit is run again by the
plain reference and ``correct`` says whether each compared number kept
its limit; the numbers and limits are the line's last key and the last
lines on standard error.

Without a CUDA card (or with fewer than the cell asks for) the run exits
with 2 and prints no result.  It imports neither JAX nor the JAX
package, and fails, printing no result, if either is loaded by the time
the result would be printed (after the check).
"""
from __future__ import annotations

import os
import sys
import time

T_MODULE = time.perf_counter()

from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _process_age_s() -> float:
    """Seconds since this process started (its start time in
    ``/proc/self/stat`` against ``/proc/uptime``), else since this
    module's first line."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_MODULE


T_PROCESS = time.perf_counter() - _process_age_s()


def _environment() -> None:
    """The program on the path, and every build and kernel cache at a
    fixed place inside the checkout (``build/``, which git ignores)."""
    for p in (str(BENCH), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    cache = ROOT / "build"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute_cache")):
        os.environ[var] = str(cache / sub)
    os.environ.setdefault("OMP_NUM_THREADS", "4")


def forbidden_modules():
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def _device_info(torch, device, chips: int, trace_info=None):
    if device.type != "cuda":
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    else:
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    if trace_info:
        info.update(trace_info)
    return info


def _power_limit() -> str:
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError, IndexError):
        return ""


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", cell_patch=None) -> dict:
    """One run of ``workload``; returns the result line's object.
    ``cell_patch(cell, config)`` edits the cell's and configuration's
    files as read (the tests run cells at a size the CPU holds)."""
    _environment()
    import torch
    from pb import manifest
    from pb.trace import WINDOW, Trace

    man = manifest.manifest()
    entry = {w["name"]: w for w in man["workloads"]}[workload]
    cell = manifest.cell_file(workload)
    config = manifest.config_file(cell["config"])
    if cell_patch is not None:
        cell_patch(cell, config)
    dev = torch.device(device)
    torch.set_num_threads(4)
    drv = manifest.load_module("drivers", cell["driver"]).Driver(
        cell, config, seed, dev, trace)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    drv.setup()
    sync()
    t_setup = time.perf_counter()
    setup_s = t_setup - T_PROCESS

    def window(limit: float):
        """Whole units until ``limit`` seconds are spent: (units,
        seconds)."""
        drv.start_window()
        units = 0
        t0 = time.perf_counter()
        marks = [t0]
        with torch.profiler.record_function(WINDOW):
            while True:
                units += drv.run_unit()
                marks.append(time.perf_counter())
                if marks[-1] - t0 >= limit:
                    break
            sync()
        t1 = time.perf_counter()
        spans = sorted(b - a for a, b in zip(marks, marks[1:]))
        print(f"window: {len(spans)} units of {units // len(spans)} "
              f"{drv.unit}s, seconds a unit min {spans[0]!r} median "
              f"{spans[len(spans) // 2]!r} max {spans[-1]!r}",
              file=sys.stderr)
        return units, t1 - t0

    units, window_s = window(seconds)
    trace_info, breakdown, tr = None, None, None
    if trace:
        # the untraced window above gives each unit's wall time; a
        # shorter one under the profiler gives the device's share of it
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        untraced = {"units": units, "window_s": window_s}
        with profile(activities=acts) as prof:
            units, _ = window(
                min(seconds, cell["traffic"].get("trace_seconds", seconds)))
        tr = Trace(prof)
        del prof
        print(f"trace: {tr.counts} events, window {tr.window_s!r} s",
              file=sys.stderr)
        trace_info = {"busy_s": tr.busy_s, "window_s": tr.window_s}
        breakdown = {"device_ops": tr.device_ops(),
                     "idle_gaps": tr.idle_gaps()}
    device_info = _device_info(torch, dev, entry["chips"], trace_info)
    peak_bytes = (torch.cuda.max_memory_allocated()
                  if dev.type == "cuda" else 0)

    values = {f"{drv.unit}_s": window_s / units,
              "peak_mem_gib": peak_bytes / 2 ** 30,
              "setup_s": setup_s}
    if tr is not None:
        ctx = {"trace": tr, "units": units, "unit": drv.unit,
               "layer": drv.layer_inputs(units), "untraced": untraced,
               "cell": cell, "config": config}
        values = {}
        for m in manifest.metrics_for(man, workload, "per_layer"):
            v = manifest.load_module("metrics", m["name"]).read(ctx)
            if v is not None:
                values[m["name"]] = v
        del ctx, tr
    group = "per_layer" if trace else "end_to_end"
    metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
               for m in manifest.metrics_for(man, workload, group)
               if m["name"] in values}

    drv.release()
    checks = drv.check()
    correct = all(c["value"] <= c["limit"] for c in checks)
    if dev.type == "cuda":
        device_info["power_limit"] = _power_limit()
    out = {"correct": correct, "attempted": units, "failed": 0,
           "metrics": metrics, "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                     for c in checks}
    # last, after the check: whatever the window, the reference or the
    # comparison loaded counts
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        raise SystemExit(3)
    return out


def main(argv=None) -> int:
    import argparse
    import json
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    _environment()
    from pb import manifest
    entry = {w["name"]: w for w in manifest.manifest()["workloads"]}.get(
        args.workload)
    if entry is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds,
                   bool(args.trace))
    sys.stdout.flush()
    for name, c in out["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {name} = {c['value']!r} limit {c['limit']!r} {ok}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
