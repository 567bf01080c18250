"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It builds the CUDA kernels from the
sources in the checkout, holds each against its plain PyTorch version on
the card, runs the sync FedHC engine through ``repro_torch.api.run`` for
the five paper methods and for fedhc at the paper's 800 satellites (with
the kernels and without), checks the results, and prints one JSON line
per phase.  The line before the last is ``{"kernels": [...]}``, the last
``{"ok": true, "device": {...}}``.  Any failure raises: nothing is caught,
and the exit code is then not 0.  Without CUDA, or outside a checkout, it
exits with an error before printing any result.  It imports nothing of
JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEV = "cuda"

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
F32_FLOPS = 67e12             # H100 SXM float32 outside the tensor cores
WAGG_TOL = 2e-5               # rtol and atol, f32 stacks (test_kernels.py)
WAGG_TOL_BF16 = 3e-2
KMEANS_D_TOL = 1e-5           # |d - d_plain| / (|x|^2 + |c|^2)
KMEANS_TIE = 1e-5             # assignments must agree where the two best
#                               distances differ by more than this, relative
TRAJ_RTOL = 1e-5              # time and energy, kernels on vs off
LOSS_RTOL = 1e-3
PAPER_METHODS = ("fedhc", "fedhc-nomaml", "h-base", "fedce", "c-fedavg")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def call_ms(fn, samples: int = 30, warmup: int = 5) -> float:
    """Median time of one eager call between CUDA events: the device time,
    or the host's launch time where that is longer (tiny kernels)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(samples):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, reps: int = 20, samples: int = 20) -> float:
    """Device time of one call: ``reps`` calls captured in a CUDA graph,
    replayed between CUDA events (median of ``samples`` replays), divided
    by ``reps``.  The host's launch cost is out of it."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def lenet_leaf_sizes():
    """Per-client element count of each LeNet leaf, in leaf order."""
    import torch
    from repro_torch.models.lenet import init_lenet
    from repro_torch.tree import tree_leaves
    g = torch.Generator(device=DEV).manual_seed(0)
    return [x.numel() for x in tree_leaves(init_lenet(g, device=g.device))]


def engine_weights(c: int, k: int, gen):
    """(C, K) stage-1 weights as the engine builds them: one-hot cluster
    membership times cluster-normalized inverse losses."""
    import torch
    from repro_torch.core import aggregation as agg
    assignment = torch.randint(0, k, (c,), generator=gen, device=DEV)
    losses = 1.0 + torch.rand((c,), generator=gen, device=DEV)
    w = agg.loss_weights(losses, assignment, k)
    return (agg.membership_one_hot(assignment, k) * w[:, None]).contiguous()


def check_weighted_agg(gen):
    """Kernel vs plain at every LeNet leaf (C = 32 and 800, K = 4) and the
    reference's sweep shapes; returns the error at the main path's shapes
    and the times of one stage-1 at C = 800."""
    import torch
    from repro_torch.kernels import ops, ref
    leaves = lenet_leaf_sizes()
    cases = [(c, p, 4, torch.float32, "engine") for c in (32, 800)
             for p in leaves]
    cases += [(c, p, k, torch.float32, "uniform")
              for c, p, k in ((4, 100, 2), (16, 3000, 5), (12, 2048, 8))]
    cases += [(c, p, 3, torch.bfloat16, "uniform")
              for c, p in ((2, 64), (16, 1000), (8, 4096), (5, 17))]
    main_err, worst = 0.0, []
    for c, p, k, dt, kind in cases:
        s = torch.randn((c, p), generator=gen, device=DEV).to(dt)
        w = (engine_weights(c, k, gen) if kind == "engine" else
             torch.rand((c, k), generator=gen, device=DEV))
        got = ops.weighted_agg_multi(s, w)
        want = ref.weighted_agg_multi_ref(s, w)
        torch.cuda.synchronize()
        tol = WAGG_TOL if dt == torch.float32 else WAGG_TOL_BF16
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        err = float((got.float() - want.float()).abs().max())
        worst.append(err)
        if c == 800:
            main_err = max(main_err, err)

    # one stage-1 of the main path: the 10 LeNet leaves at C = 800, K = 4
    c, k = 800, 4
    stacks = [torch.randn((c, p), generator=gen, device=DEV)
              for p in leaves]
    w = engine_weights(c, k, gen)
    wt = w.T
    def kernel():
        return [ops.weighted_agg_multi(s, w) for s in stacks]
    kernel_ms = device_ms(kernel)
    plain_ms = device_ms(lambda: [ref.weighted_agg_multi_ref(s, w)
                                  for s in stacks])
    library_ms = device_ms(lambda: [torch.matmul(wt, s) for s in stacks])
    big = stacks[leaves.index(max(leaves))]
    big_ms = device_ms(lambda: ops.weighted_agg_multi(big, w))
    big_library_ms = device_ms(lambda: torch.matmul(wt, big))
    n_bytes = sum(4 * (c * p + c * k + k * p) for p in leaves)
    n_ops = sum(2 * c * k * p for p in leaves)
    bound_s = max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOPS)
    return {
        "max_abs_err": main_err, "max_abs_err_all_shapes": max(worst),
        "cases": len(cases), "ms": kernel_ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "bound_ms": bound_s * 1e3,
        "bound_by": ("bytes" if n_bytes / HBM_BYTES_PER_S
                     >= n_ops / F32_FLOPS else "operations"),
        "call_ms": call_ms(kernel),
        "largest_leaf_ms": big_ms, "largest_leaf_library_ms": big_library_ms,
        "largest_leaf_bound_ms": 4 * (c * max(leaves) + c * k
                                      + k * max(leaves))
        / HBM_BYTES_PER_S * 1e3,
        "shape": f"one stage-1: {len(leaves)} LeNet leaves, C={c}, K={k}, "
                 f"P={sum(leaves)} in all, f32",
    }


def check_kmeans(gen):
    """Kernel vs plain on constellation positions (N = 32, 800, 10000;
    D = 3, K = 4) and on (1000, 10, 7) normals; times at N = 800."""
    import torch
    from repro_torch.core.engine import _constellation_for
    from repro_torch.kernels import ops, ref
    cases = []
    for n in (32, 800, 10000):
        x = _constellation_for(n).positions(
            torch.tensor(1234.5, device=DEV))
        cent = (x[torch.randperm(n, generator=gen, device=DEV)[:4]]
                + 50.0 * torch.randn((4, 3), generator=gen, device=DEV))
        cases.append((x.contiguous(), cent.contiguous()))
    cases.append((torch.randn((1000, 10), generator=gen, device=DEV),
                  torch.randn((7, 10), generator=gen, device=DEV)))
    main_err = 0.0
    for x, cent in cases:
        a, d = ops.kmeans_assign(x, cent)
        ar, dr = ref.kmeans_assign_ref(x, cent)
        torch.cuda.synchronize()
        scale = (x * x).sum(-1).max() + (cent * cent).sum(-1).max()
        err = float((d - dr).abs().max())
        assert err <= KMEANS_D_TOL * float(scale), (err, float(scale))
        dist = ((x * x).sum(-1)[:, None] - 2.0 * x @ cent.T
                + (cent * cent).sum(-1))
        two = dist.topk(2, dim=1, largest=False).values
        clear = (two[:, 1] - two[:, 0]) > KMEANS_TIE * two[:, 1].abs()
        assert torch.equal(a[clear], ar[clear]), "kmeans_assign disagrees"
        assert a.dtype == torch.int32 and int(a.min()) >= 0
        if x.shape[0] == 800:
            main_err = err
    x, cent = cases[1]
    n, dd = x.shape
    k = cent.shape[0]
    kernel_ms = device_ms(lambda: ops.kmeans_assign(x, cent))
    plain_ms = device_ms(lambda: ref.kmeans_assign_ref(x, cent))
    n_bytes = 4 * (n * dd + k * dd + 2 * n)
    n_ops = n * k * (2 * dd + 3)
    return {
        "max_abs_err": main_err, "cases": len(cases), "ms": kernel_ms,
        "call_ms": call_ms(lambda: ops.kmeans_assign(x, cent)),
        "plain_ms": plain_ms, "library_ms": None,
        "bound_ms": max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOPS) * 1e3,
        "bound_by": ("bytes" if n_bytes / HBM_BYTES_PER_S
                     >= n_ops / F32_FLOPS else "operations"),
        "shape": f"N={n}, D={dd}, K={k}, f32 (the per-round drift check)",
    }


def profile_round_loop(sc) -> dict:
    """Device time by kernel over one run's round loop (setup excluded),
    from torch.profiler, beside the same loop's wall time measured without
    the profiler (whose host overhead would swell it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import engine
    cfg = sc.to_flat()
    state0, data = engine.setup(cfg, device=DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.simulate(cfg, device=DEV, state0=state0, data=data)
    wall_ms = (time.perf_counter() - t0) * 1e3   # ends in the history fetch
    on_card = DEV == "cuda"
    with profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_card else [])) as prof:
        engine.simulate(cfg, device=DEV, state0=state0, data=data)
    kind = (torch.autograd.DeviceType.CUDA if on_card
            else torch.autograd.DeviceType.CPU)
    kernels = []
    for e in prof.key_averages():
        if e.device_type != kind:
            continue
        us = getattr(e, "self_device_time_total", 0)
        kernels.append((us / 1e3, e.key, e.count))
    kernels.sort(reverse=True)
    busy_ms = sum(k[0] for k in kernels)
    return {"phase": "profile", "method": cfg.method,
            "num_clients": cfg.num_clients, "rounds": cfg.rounds,
            "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": (1.0 - busy_ms / wall_ms) if wall_ms else None,
            "kernel_launches": sum(k[2] for k in kernels),
            "top": [{"name": k[1][:90], "device_ms": k[0], "count": k[2]}
                    for k in kernels[:15]]}


def check_result(res, rounds: int, eval_every: int) -> None:
    import numpy as np
    want = sorted({r for r in range(eval_every, rounds + 1, eval_every)}
                  | {rounds})
    assert res.round.tolist() == want, (res.round, want)
    for key in ("acc", "loss", "time_s", "energy_j"):
        v = getattr(res, key)
        assert v.shape == (len(want),) and np.all(np.isfinite(v)), (key, v)
    assert np.all((res.acc >= 0) & (res.acc <= 1))
    assert np.all(np.diff(res.time_s) > 0) and np.all(np.diff(res.energy_j) > 0)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one NVIDIA GPU",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository "
              f"(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import api, device as device_lib
    from repro_torch.api import ExecSpec, FleetSpec, Scenario, TrainSpec
    from repro_torch.kernels import build, ops

    # ---- 1. device -----------------------------------------------------
    device_lib.resolve("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # ---- 2. build ------------------------------------------------------
    t0 = time.perf_counter()
    nvcc_s = build.build_all()
    for src in build.SOURCES:
        build.load(src)
    emit({"phase": "build", "nvcc_s": round(nvcc_s, 3),
          "build_and_load_s": round(time.perf_counter() - t0, 3),
          "sources": [f"src/repro_torch/csrc/{s}.cu" for s in build.SOURCES]})

    # ---- 3. kernels vs plain on the card ---------------------------------
    gen = torch.Generator(device=DEV).manual_seed(11)
    wagg = check_weighted_agg(gen)
    km = check_kmeans(gen)
    emit({"phase": "kernels_vs_plain", "weighted_agg_multi": wagg,
          "kmeans_assign": km})
    gc.collect()            # the checks' tensors and graphs: out of the
    torch.cuda.empty_cache()  # main path's peak-memory readings

    # ---- 4. main path --------------------------------------------------
    def scenario(method, n, use_kernels, **fleet):
        return Scenario(method=method,
                        fleet=FleetSpec(num_clients=n, num_clusters=4,
                                        **fleet),
                        train=TrainSpec(rounds=10, eval_every=5),
                        exec=ExecSpec(use_pallas_kernels=use_kernels))

    ops.reset_launches()
    paper = {}
    for m in PAPER_METHODS:
        res = api.run(scenario(m, 32, True), device=DEV)
        check_result(res, 10, 5)
        paper[m] = {"acc": res.acc.tolist(), "loss": res.loss.tolist(),
                    "time_s": res.time_s.tolist(),
                    "reclusters": res.reclusters,
                    "run_s_per_round": res.run_s / 10,
                    "peak_device_mem_mb": res.peak_device_mem_mb}
    fed = [m for m in PAPER_METHODS if m != "c-fedavg"]
    n_recl = sum(paper[m]["reclusters"] for m in fed)
    assert ops.LAUNCHES["kmeans_assign"] == 10 * len(fed), ops.LAUNCHES
    assert ops.LAUNCHES["weighted_agg_multi"] == 10 * (10 * len(fed)
                                                        + n_recl), ops.LAUNCHES
    emit({"phase": "paper_methods", "num_clients": 32, "num_clusters": 4,
          "rounds": 10, "launches": dict(ops.LAUNCHES), "runs": paper})

    # fedhc at the paper's 800 satellites, with the kernels and without;
    # 4-minute rounds and Z = 0.2 (the reference's own kernel-flag parity
    # setting) so the re-cluster branch and its MAML hand-off run too
    drift = dict(round_minutes=4.0, dropout_threshold=0.2)
    ops.reset_launches()
    on = api.run(scenario("fedhc", 800, True, **drift), device=DEV)
    launches = dict(ops.LAUNCHES)
    ops.reset_launches()
    off = api.run(scenario("fedhc", 800, False, **drift), device=DEV)
    assert ops.LAUNCHES == {"weighted_agg_multi": 0, "kmeans_assign": 0}
    for res in (on, off):
        check_result(res, 10, 5)
    assert on.reclusters == off.reclusters >= 1, (on.reclusters,
                                                  off.reclusters)
    assert launches["kmeans_assign"] == 10, launches
    assert launches["weighted_agg_multi"] == 10 * (10 + on.reclusters), \
        launches
    for key, rtol in (("time_s", TRAJ_RTOL), ("energy_j", TRAJ_RTOL),
                      ("loss", LOSS_RTOL)):
        a, b = getattr(on, key), getattr(off, key)
        assert all(abs(x - y) <= rtol * abs(y) for x, y in zip(a, b)), \
            (key, a, b)
    emit({"phase": "paper_scale", "method": "fedhc", "num_clients": 800,
          "num_clusters": 4, "rounds": 10, **drift,
          "launches": launches, "reclusters": on.reclusters,
          "kernels_on": {"acc": on.acc.tolist(), "loss": on.loss.tolist(),
                         "time_s": on.time_s.tolist(),
                         "energy_j": on.energy_j.tolist(),
                         "setup_s": on.setup_s, "compile_s": on.compile_s,
                         "run_s_per_round": on.run_s / 10,
                         "peak_device_mem_mb": on.peak_device_mem_mb},
          "kernels_off": {"acc": off.acc.tolist(), "loss": off.loss.tolist(),
                          "time_s": off.time_s.tolist(),
                          "energy_j": off.energy_j.tolist(),
                          "run_s_per_round": off.run_s / 10,
                          "peak_device_mem_mb": off.peak_device_mem_mb}})

    # ---- 5. where the time goes: fedhc at N = 800 under torch.profiler ----
    emit(profile_round_loop(scenario("fedhc", 800, True, **drift)))

    # ---- 6. the kernels line ---------------------------------------------
    rows = []
    for kname, src, replaces, m in (
            ("weighted_agg_multi", "src/repro_torch/csrc/weighted_agg.cu",
             "src/repro/kernels/weighted_agg.py:76", wagg),
            ("kmeans_assign", "src/repro_torch/csrc/kmeans.cu",
             "src/repro/kernels/kmeans.py:35", km)):
        rows.append({"name": kname, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[kname],
                     "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                     "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                     "bound_by": m["bound_by"],
                     "library_ms": m["library_ms"], "shape": m["shape"]})
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
