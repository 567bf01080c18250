"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It builds the CUDA kernels from the
sources in the checkout (printing each kernel's registers, shared memory
and spills from ptxas), holds each against its plain PyTorch version on
the card (flash_attention on both routes: bf16 on the tensor cores, f32 on
the CUDA cores), times the kernels beside their bounds, their plain
versions, one PyTorch call of the same function and the floor of one
launch, runs the sync FedHC engine through ``repro_torch.api.run`` for
the five paper methods and for fedhc at the paper's 800 satellites (with
the kernels and without, in turns, three times each), builds the contact
plan of those 800 satellites and runs the visibility-gated methods
fedspace and isl-onboard on it (kernels on and off; fedspace also on the
sliced and factorized plans), holds weighted_agg_multi at K = 17 and 32
and over 65 leaves and runs fedhc at K = 17 and 32, runs
seed sweeps (fedhc, and fedspace on one plan) against single runs and
the five paper methods on the MNIST_K4 preset, runs the async event
engine (fedbuff, fedhc-async, fedspace-async at N = 800, kernels on and
off, and the full cohort against the sync engine), runs fedhc at N = 800
with flight telemetry off and on (histories equal with ``==``, host
reads, launches and synchronizing calls equal, the overhead, device time
by ``fed_step/*`` scope, a Chrome trace under ``chiprun_out/``) and
fedspace and fedhc-async with telemetry on, runs a 16-cell grid at N =
800 through the fleet sweep service (every cell against its own
``api.run``; the grid resumed as a no-op), serves the full
gemma2-2b (26 layers, bf16, random weights) through
``repro_torch.launch.serve.serve_batch`` with a prompt longer than its
4096-token window, checks prefill + decode against a longer prefill,
profiles one prefill, and prints one JSON line per phase.  The line
before the last is ``{"kernels": [...]}``, the last
``{"ok": true, "device": {...}}``.  Any failure raises: nothing is caught,
and the exit code is then not 0.  Without CUDA, or outside a checkout, it
exits with an error before printing any result.  It imports nothing of
JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import contextlib
import gc
import json
import re
import statistics
import subprocess
import sys
import time
import traceback
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEV = "cuda"
T_START = time.perf_counter()

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
F32_FLOPS = 67e12             # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12           # H100 SXM bf16 tensor cores, dense
WAGG_TOL = 2e-5               # rtol and atol, f32 stacks (test_kernels.py)
WAGG_TOL_BF16 = 3e-2
WAGG1_TOL = 1e-5              # weighted_agg sweep (test_kernels.py)
FLASH_TOL = 3e-5              # rtol and atol, flash sweep (test_kernels.py)
FLASH_TOL_BF16 = 4e-2
# gemma2-2b's layer shapes in bf16: both sides compute in f32 from the same
# bf16 inputs and round the output to bf16, so they differ by at most one
# bf16 ulp (2^-7 of the value, under rtol); outputs there are ~0.02-0.03
# (thousands of live keys), so the sweep's 4e-2 would pass a dropped kv tile.
# The f32 run at the same shapes holds the kernel to FLASH_TOL.
FLASH_LAYER_RTOL_BF16 = 1e-2
FLASH_LAYER_ATOL_BF16 = 1e-3
KMEANS_D_TOL = 1e-5           # |d - d_plain| / (|x|^2 + |c|^2)
KMEANS_TIE = 1e-5             # assignments must agree where the two best
#                               distances differ by more than this, relative
KMEANS_TURNS = 7              # kmeans_assign and the launch floors, in turns
TRAJ_RTOL = 1e-5              # time and energy, kernels on vs off
LOSS_RTOL = 1e-3
ACC_ATOL = 5e-3               # accuracy, the golden bar
PAPER_METHODS = ("fedhc", "fedhc-nomaml", "h-base", "fedce", "c-fedavg")
CONTACT_N = 800               # the paper's constellation: 25 planes of 32
SWEEP_SEEDS = (17, 18, 19)    # the reference's benchmarks/fl_common.py
PRESET_ROUNDS = 100           # MNIST_K4's 300 rounds, cut to fit the script
ASYNC_EVENTS = 40
ASYNC_METHODS = ("fedbuff", "fedhc-async", "fedspace-async")
# the reference's flash sweep (tests/test_kernels.py):
# B, Hq, Hkv, Sq, Sk, D, causal, window, softcap
FLASH_CASES = [
    (1, 4, 2, 128, 128, 64, True, 0, 0.0),
    (2, 4, 4, 96, 96, 32, True, 0, 50.0),
    (1, 8, 2, 256, 256, 64, True, 64, 0.0),
    (1, 2, 1, 1, 300, 64, True, 0, 0.0),
    (1, 2, 1, 1, 300, 64, True, 128, 0.0),
    (1, 2, 2, 128, 128, 64, False, 0, 0.0),
    (2, 2, 2, 70, 70, 128, True, 0, 0.0),
]
SERVE_BATCH, SERVE_PROMPT, SERVE_TOKENS = 2, 8192, 32
DECODE_STEPS = 8              # decode steps in the profile phase
# gemma2-2b's attention layers: B, Hq, Hkv, S, D, soft-cap; window 4096
FLASH_LAYER = (SERVE_BATCH, 8, 4, SERVE_PROMPT, 256, 50.0)
# prefill over S + 1 tokens against prefill over S then one decode step:
# float32 at full width and 2 layers, both sides sum the same products in
# other orders (a 4097-row GEMM and flash tiles against a 1-row GEMM and the
# decode's direct attention) over 2304-wide rows: float32 rounding of logits
# of order 1 (capped at +-30) stays near 1e-5
CONSIST_TOL_F32 = 1e-4
# bfloat16 at full depth: each side rounds every activation to bf16 (8 bits
# of mantissa) after differently ordered sums, and a flipped rounding
# carries through 26 residual layers; two ulps of a bf16 logit near the
# +-30 cap (0.125 each)
CONSIST_TOL_BF16 = 0.25


def emit(obj) -> None:
    """One JSON line; a phase line also says when it ended (script s)."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T_START}
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
    """Kernel vs plain: one leaf at every LeNet leaf size (C = 32 and 800,
    K = 4) and the reference's sweep shapes, then the grouped launch over
    LeNet's 10 leaves (C = 32 and 800, K = 1, 4, 16, f32 and bf16; C =
    10,000, K = 4, f32): one launch a tree, the same bits from two calls.
    Times one stage-1 (the 10 leaves, K = 4, f32) at C = 800 and 10,000,
    beside the plain version and 10 ``torch.matmul``s."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import weighted_agg as _wagg
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

    def tree_check(c, k, dt):
        """One grouped launch over LeNet's leaves vs plain, leaf by leaf;
        returns the largest error."""
        stacks = tuple(torch.randn((c, p), generator=gen, device=DEV).to(dt)
                       for p in leaves)
        w = engine_weights(c, k, gen)
        before = ops.LAUNCHES["weighted_agg_multi"]
        got = ops.weighted_agg_multi_tree(stacks, w)
        again = ops.weighted_agg_multi_tree(stacks, w)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["weighted_agg_multi"] == before + 2
        assert all(torch.equal(a, b) for a, b in zip(got, again)), \
            "two calls differ"
        tol = WAGG_TOL if dt == torch.float32 else WAGG_TOL_BF16
        err = 0.0
        for g, x in zip(got, stacks):
            want = ref.weighted_agg_multi_ref(x, w)
            assert g.shape == want.shape and g.dtype == dt
            torch.testing.assert_close(g.float(), want.float(), rtol=tol,
                                       atol=tol)
            err = max(err, float((g.float() - want.float()).abs().max()))
        return err
    trees = {f"C={c},K={k},{str(dt)[6:]}": tree_check(c, k, dt)
             for c in (32, 800) for k in (1, 4, 16)
             for dt in (torch.float32, torch.bfloat16)}
    main_err = max(main_err, trees["C=800,K=4,float32"])

    def stage1(c, k=4):
        """The main path's stage-1 at C clients: times and bound."""
        stacks = tuple(torch.randn((c, p), generator=gen, device=DEV)
                       for p in leaves)
        w = engine_weights(c, k, gen)
        wt = w.T
        got = ops.weighted_agg_multi_tree(stacks, w)
        torch.cuda.synchronize()
        err = max(float((g - ref.weighted_agg_multi_ref(x, w)).abs().max())
                  for g, x in zip(got, stacks))
        assert err <= WAGG_TOL, err

        def kernel():
            return ops.weighted_agg_multi_tree(stacks, w)
        n_bytes = sum(4 * (c * p + c * k + k * p) for p in leaves)
        n_ops = sum(2 * c * k * p for p in leaves)
        pl = _wagg.plan_grouped(leaves, c, k, torch.float32,
                                [_wagg._aligned(x) for x in stacks])
        row = {"C": c, "K": k, "max_abs_err": err, "ms": device_ms(kernel),
               "plain_ms": device_ms(
                   lambda: [ref.weighted_agg_multi_ref(s, w)
                            for s in stacks]),
               "library_ms": device_ms(
                   lambda: [torch.matmul(wt, s) for s in stacks]),
               "bound_ms": max(n_bytes / HBM_BYTES_PER_S,
                               n_ops / F32_FLOPS) * 1e3,
               "bound_by": ("bytes" if n_bytes / HBM_BYTES_PER_S
                            >= n_ops / F32_FLOPS else "operations"),
               "blocks": pl.blocks}
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        assert row["ms"] < row["library_ms"], row
        return row, stacks, w

    # one stage-1 of the main path: the 10 LeNet leaves at C = 800, K = 4
    main, stacks, w = stage1(800)
    wt = w.T
    big = stacks[leaves.index(max(leaves))]
    c, k = w.shape
    res = {
        "max_abs_err": main_err, "max_abs_err_all_shapes": max(worst),
        "cases": len(cases), "trees": trees, **main,
        "call_ms": call_ms(lambda: ops.weighted_agg_multi_tree(stacks, w)),
        "per_leaf_ms": device_ms(lambda: [ops.weighted_agg_multi(s, w)
                                          for s in stacks]),
        "per_leaf_call_ms": call_ms(lambda: [ops.weighted_agg_multi(s, w)
                                             for s in stacks]),
        "largest_leaf_ms": device_ms(lambda: ops.weighted_agg_multi(big, w)),
        "largest_leaf_library_ms": device_ms(lambda: torch.matmul(wt, big)),
        "largest_leaf_bound_ms": 4 * (c * max(leaves) + c * k
                                      + k * max(leaves))
        / HBM_BYTES_PER_S * 1e3,
        "shape": f"one stage-1: {len(leaves)} LeNet leaves, C={c}, K={k}, "
                 f"P={sum(leaves)} in all, f32",
    }
    del stacks, big
    # the scale of 10,000 clients: one stage-1 reads 1.78 GB
    res["c10000"], stacks, w = stage1(10_000)
    del stacks, w
    gc.collect()
    torch.cuda.empty_cache()
    return res


def check_kmeans(gen):
    """Kernel vs plain on constellation positions (N = 32, 800, 10000;
    D = 3, K = 4) and on (1000, 10, 7) normals; times at N = 800, beside
    the floor of one launch (``t.zero_()`` on a one-element tensor) and of
    one launch that reads (``t.copy_(u)``), timed in turns with it."""
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
    # the floor of one launch: the smallest kernel PyTorch makes (zero_ of
    # one element), and the smallest that reads before it writes (copy_ of
    # one element), timed by the same harness in turns with the kernel,
    # KMEANS_TURNS times, so that a change of clocks enters no one ratio
    one, src = torch.zeros((1,), device=DEV), torch.ones((1,), device=DEV)
    floor_runs, read_runs, kernel_runs = [], [], []
    for _ in range(KMEANS_TURNS):
        floor_runs.append(device_ms(one.zero_))
        kernel_runs.append(device_ms(lambda: ops.kmeans_assign(x, cent)))
        read_runs.append(device_ms(lambda: one.copy_(src)))
    kernel_ms = statistics.median(kernel_runs)
    floor_ms = statistics.median(floor_runs)
    plain_ms = device_ms(lambda: ref.kmeans_assign_ref(x, cent))
    n_bytes = 4 * (n * dd + k * dd + 2 * n)
    n_ops = n * k * (2 * dd + 3)
    return {
        "max_abs_err": main_err, "cases": len(cases), "ms": kernel_ms,
        "launch_floor_ms": floor_ms, "ms_over_floor": kernel_ms / floor_ms,
        "ms_runs": kernel_runs, "launch_floor_runs": floor_runs,
        "ms_over_floor_runs": [a / b for a, b in zip(kernel_runs,
                                                     floor_runs)],
        "read_floor_ms": statistics.median(read_runs),
        "read_floor_runs": read_runs,
        "call_ms": call_ms(lambda: ops.kmeans_assign(x, cent)),
        "plain_ms": plain_ms, "library_ms": None,
        "bound_ms": max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOPS) * 1e3,
        "bound_by": ("bytes" if n_bytes / HBM_BYTES_PER_S
                     >= n_ops / F32_FLOPS else "operations"),
        "shape": f"N={n}, D={dd}, K={k}, f32 (the per-round drift check)",
    }


def check_weighted_agg_single(gen):
    """The K = 1 kernel (``weighted_agg``: the streaming small-C kernel) vs
    plain on the reference's sweep shapes and at C = 32, P = 1e6; times at
    kernel_bench.py's C = 16, P = 1,000,000 f32, and across the small-C
    threshold."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import weighted_agg as _wagg
    cases = [(c, p, dt) for c, p in ((2, 64), (16, 1000), (8, 4096), (5, 17),
                                     (32, 1_000_000))
             for dt in (torch.float32, torch.bfloat16)]
    worst = 0.0
    for c, p, dt in cases:
        s = torch.randn((c, p), generator=gen, device=DEV).to(dt)
        w = torch.rand((c,), generator=gen, device=DEV)
        got = ops.weighted_agg(s, w)
        want = ref.weighted_agg_ref(s, w)
        torch.cuda.synchronize()
        tol = WAGG1_TOL if dt == torch.float32 else WAGG_TOL_BF16
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        worst = max(worst, float((got.float() - want.float()).abs().max()))
    # the small-C threshold: the streaming kernel against the
    # weighted_agg_multi kernel (K = 1) and cuBLAS across it, P = 1e6 f32
    threshold = []
    for c in (8, 16, 32, 64):
        s = torch.randn((c, 1_000_000), generator=gen, device=DEV)
        w = torch.rand((c, 1), generator=gen, device=DEV)
        row = {"C": c, "multi_ms": device_ms(
            lambda: _wagg.launch(s, w, small_c_max=0)),
            "library_ms": device_ms(lambda: torch.matmul(w[:, 0], s)),
            "bound_ms": 4 * (c * s.shape[1] + c + s.shape[1])
            / HBM_BYTES_PER_S * 1e3}
        if c <= _wagg.SMALL_C_MAX:
            row["small_c_ms"] = device_ms(lambda: _wagg.launch(s, w))
        threshold.append(row)
    c, p = 16, 1_000_000
    s = torch.randn((c, p), generator=gen, device=DEV)
    w = torch.rand((c,), generator=gen, device=DEV)
    err = float((ops.weighted_agg(s, w) - ref.weighted_agg_ref(s, w))
                .abs().max())
    n_bytes = 4 * (c * p + c + p)
    n_ops = 2 * c * p
    return {
        "max_abs_err": err, "max_abs_err_sweep": worst, "cases": len(cases),
        "kernel": type(_wagg.plan(c, p, k=1, vec4=True)).__name__,
        "ms": device_ms(lambda: ops.weighted_agg(s, w)),
        "plain_ms": device_ms(lambda: ref.weighted_agg_ref(s, w)),
        "library_ms": device_ms(lambda: torch.matmul(w, s)),
        "bound_ms": max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOPS) * 1e3,
        "bound_by": ("bytes" if n_bytes / HBM_BYTES_PER_S
                     >= n_ops / F32_FLOPS else "operations"),
        "threshold": threshold,
        "shape": f"C={c}, P={p}, f32 (benchmarks/kernel_bench.py)",
    }


def flash_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """Live (q, k) pairs of one head: the band the masks leave."""
    total = 0
    for i in range(sq):
        qp = sk - sq + i
        hi = min(sk, qp + 1) if causal else sk
        lo = max(0, qp - window + 1) if window else 0
        total += max(0, hi - lo)
    return total


def flex_attention_call(s: int, window: int, cap: float):
    """The one PyTorch call that computes flash_attention's function:
    ``flex_attention`` compiled with a soft-cap ``score_mod``, a causal /
    window block mask and ``enable_gqa``.  A yardstick only: the port never
    calls it."""
    import torch
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)

    def softcap(score, b, h, qi, ki):
        return cap * torch.tanh(score / cap)

    def band(b, h, qi, ki):
        live = ki <= qi
        return live & (ki > qi - window) if window else live
    mask = create_block_mask(band, None, None, s, s, device=DEV)
    fn = torch.compile(flex_attention)
    return lambda q, k, v: fn(q, k, v, score_mod=softcap, block_mask=mask,
                              enable_gqa=True)


def check_flash(gen):
    """The flash kernel vs plain on the reference's sweep (f32 and bf16) and
    at gemma2-2b's global and local layer shapes (B = 2, Hq = 8, Hkv = 4,
    S = 8192, D = 256, soft-cap 50, window 0 / 4096; f32 and bf16), timed
    there on both routes (bf16 on the tensor cores, f32 on the CUDA cores)
    beside the plain version, the bound, ``flex_attention`` (the same
    function, in each route's dtype) and SDPA (causal, GQA; it applies
    neither the soft-cap nor the window, so it is a different
    function)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref

    def qkv(b, hq, hkv, sq, sk, d, dt):
        return (torch.randn((b, hq, sq, d), generator=gen, device=DEV).to(dt),
                torch.randn((b, hkv, sk, d), generator=gen, device=DEV).to(dt),
                torch.randn((b, hkv, sk, d), generator=gen, device=DEV).to(dt))

    sweep = {}
    for case in FLASH_CASES:
        causal, window, cap = case[6:]
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = qkv(*case[:6], dt)
            got = ops.flash_attention(q, k, v, causal=causal, window=window,
                                      softcap=cap)
            torch.cuda.synchronize()
            want = ref.flash_attention_ref(q, k, v, causal=causal,
                                           window=window, softcap=cap)
            tol = FLASH_TOL if dt == torch.float32 else FLASH_TOL_BF16
            torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                       atol=tol)
            assert got.dtype == dt and got.shape == q.shape
            sweep[f"{case}/{str(dt)[6:]}"] = float(
                (got.float() - want.float()).abs().max())

    layers = {}
    b, hq, hkv, s, d, cap = FLASH_LAYER
    for kind, window in (("global", 0), ("local", 4096)):
        q, k, v = qkv(b, hq, hkv, s, s, d, torch.float32)
        ops.reset_launches()
        got = ops.flash_attention(q, k, v, window=window, softcap=cap)
        torch.cuda.synchronize()
        assert ops.FLASH_ROUTES == {"tensor_cores": 0, "cuda_cores": 1}
        want = ref.flash_attention_ref(q, k, v, window=window, softcap=cap)
        torch.testing.assert_close(got, want, rtol=FLASH_TOL, atol=FLASH_TOL)
        err_f32 = float((got - want).abs().max())
        f32_ms = device_ms(
            lambda: ops.flash_attention(q, k, v, window=window, softcap=cap),
            reps=1, samples=3)
        f32_plain_ms = device_ms(
            lambda: ref.flash_attention_ref(q, k, v, window=window,
                                            softcap=cap), reps=1, samples=3)
        # the same function in one PyTorch call, in f32 with TF32 off (as
        # repro_torch.device sets it for the whole process)
        assert not torch.backends.cuda.matmul.allow_tf32
        flex = flex_attention_call(s, window, cap)
        f32_lib_err = float((flex(q, k, v) - want).abs().max())
        f32_lib_ms = device_ms(lambda: flex(q, k, v), reps=1, samples=3)
        q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
        del got, want
        ops.reset_launches()
        got = ops.flash_attention(q, k, v, window=window, softcap=cap)
        torch.cuda.synchronize()
        assert ops.FLASH_ROUTES == {"tensor_cores": 1, "cuda_cores": 0}
        want = ref.flash_attention_ref(q, k, v, window=window, softcap=cap)
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=FLASH_LAYER_RTOL_BF16,
                                   atol=FLASH_LAYER_ATOL_BF16)
        diff = got.float() - want.float()
        err = float(diff.abs().max())
        rel_rms = float(diff.square().mean().sqrt()
                        / want.float().square().mean().sqrt())
        lib_err = float((flex(q, k, v).float() - want.float()).abs().max())
        del got, want, diff
        pairs = b * hq * flash_pairs(s, s, True, window)
        n_ops = 4 * d * pairs
        n_bytes = 2 * (2 * q.numel() + 2 * k.numel())
        kernel_ms = device_ms(
            lambda: ops.flash_attention(q, k, v, window=window, softcap=cap),
            reps=2, samples=5)
        bound_ms = max(n_bytes / HBM_BYTES_PER_S, n_ops / BF16_FLOPS) * 1e3
        layers[kind] = {
            "window": window, "route": "tensor_cores", "max_abs_err": err,
            "rel_rms_err": rel_rms, "ms": kernel_ms,
            "plain_ms": device_ms(
                lambda: ref.flash_attention_ref(q, k, v, window=window,
                                                softcap=cap),
                reps=1, samples=3),
            "library_ms": device_ms(lambda: flex(q, k, v), reps=2,
                                    samples=5),
            "library": "flex_attention (soft-cap score_mod, band block "
                       "mask, enable_gqa; torch.compile)",
            "library_max_abs_err": lib_err,
            "sdpa_ms": device_ms(
                lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True),
                reps=2, samples=5),
            "sdpa": "a different function: causal, no soft-cap, no window",
            "bound_ms": bound_ms,
            "bound_by": ("bytes" if n_bytes / HBM_BYTES_PER_S
                         >= n_ops / BF16_FLOPS else "operations"),
            "share_of_bound": bound_ms / kernel_ms,
            "live_pairs": pairs, "gflop": n_ops / 1e9,
            "tflop_per_s": n_ops / kernel_ms / 1e9,
            "f32": {"route": "cuda_cores", "max_abs_err": err_f32,
                    "ms": f32_ms, "plain_ms": f32_plain_ms,
                    "library_ms": f32_lib_ms,
                    "library_max_abs_err": f32_lib_err,
                    "library": "flex_attention in f32, TF32 off",
                    "tflop_per_s": n_ops / f32_ms / 1e9,
                    "bound_ms": n_ops / F32_FLOPS * 1e3},
        }
        del q, k, v
        gc.collect()
        torch.cuda.empty_cache()
    # one prefill of the main path: 13 global and 13 local layers
    per_prefill = {key: 13 * (layers["global"][key] + layers["local"][key])
                   for key in ("ms", "plain_ms", "library_ms", "sdpa_ms",
                               "bound_ms")}
    f32 = {key: 13 * (layers["global"]["f32"][key]
                      + layers["local"]["f32"][key])
           for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    return {
        "max_abs_err": max(layers[x]["max_abs_err"] for x in layers),
        "max_abs_err_sweep": max(sweep.values()), "cases": len(sweep),
        "sweep": sweep, "layers": layers, **per_prefill,
        "bound_by": layers["global"]["bound_by"],
        "f32_route": {**f32, "bound_by": "operations",
                      "max_abs_err": max(layers[x]["f32"]["max_abs_err"]
                                         for x in layers),
                      "shape": "the same 26 layers in f32 on the CUDA cores"},
        "shape": "one gemma2-2b prefill's 26 launches: 13 global + 13 local "
                 "(window 4096) layers of B=2, Hq=8, Hkv=4, S=8192, D=256, "
                 "bf16, soft-cap 50",
    }


def short_kernel_name(row: dict) -> dict:
    """A ptxas row with its mangled name cut to the kernel's name and
    template arguments (``flash_fwd_sm90_kernel<256>``)."""
    name = row.get("kernel", "")
    if not name.startswith("_ZN"):
        return row
    pos, ids = 3, []
    while pos < len(name) and name[pos].isdigit():     # nested names
        n = re.match(r"\d+", name[pos:]).group()
        pos += len(n)
        ids.append(name[pos:pos + int(n)])
        pos += int(n)
    args = []
    if name[pos:pos + 1] == "I":                       # template arguments
        pos += 1
        while pos < len(name) and name[pos] != "E":
            m = re.match(r"Li(\d+)E|f|(\d+)", name[pos:])
            if m is None:
                break
            if m.group(2):                             # a named type
                n = int(m.group(2))
                start = pos + len(m.group(2))
                args.append(name[start:start + n])
                pos = start + n
            else:
                args.append(m.group(1) or "float")
                pos += len(m.group())
    short = ids[-1] + (f"<{', '.join(args)}>" if args else "")
    return {**row, "kernel": short}


def last_logits_consistency(cfg, params, prompts):
    """prefill_last over S + 1 tokens vs prefill over S tokens then one
    decode_step of token S + 1: the last position's logits, (B, V) each."""
    import torch
    from repro_torch.models import decode_step
    from repro_torch.models.model import prefill_last
    s = prompts.shape[1] - 1
    with torch.inference_mode():
        full, _ = prefill_last(cfg, params, {"tokens": prompts}, s + 1)
        _, caches = prefill_last(cfg, params, {"tokens": prompts[:, :s]},
                                 s + 1)
        step, _ = decode_step(cfg, params, caches, prompts[:, s:], s)
        del caches
    full, step = full.float(), step[:, 0].float()
    assert torch.isfinite(full).all() and torch.isfinite(step).all()
    diff = (full - step).abs()
    return {"max_abs_err": float(diff.max()),
            "rms_err": float(diff.square().mean().sqrt()),
            "logit_rms": float(full.square().mean().sqrt()),
            "argmax_agree": float((full.argmax(-1) == step.argmax(-1))
                                  .float().mean())}


def device_kernels(prof):
    """(device ms, name, count) of each kernel in a profile, largest first."""
    import torch
    kernels = [(getattr(e, "self_device_time_total", 0) / 1e3, e.key, e.count)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return sorted(kernels, reverse=True)


def profile_serving(cfg, params, prompts, prefill_wall_s: float) -> dict:
    """Device time by kernel over one full prefill, and over DECODE_STEPS
    decode steps after it, under torch.profiler; each beside the same
    work's unprofiled wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import decode_step
    from repro_torch.models.model import prefill_last
    s = prompts.shape[1]
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.inference_mode():
        with profile(activities=acts) as prof:
            prefill_last(cfg, params, {"tokens": prompts}, s + SERVE_TOKENS)
            torch.cuda.synchronize()
        pre = device_kernels(prof)
        logits, caches = prefill_last(cfg, params, {"tokens": prompts},
                                      s + SERVE_TOKENS)
        tok = logits.argmax(-1)[:, None]

        def steps(first):
            for i in range(first, first + DECODE_STEPS):
                decode_step(cfg, params, caches, tok, s + i)
            torch.cuda.synchronize()
        steps(0)                                  # warm
        t0 = time.perf_counter()
        steps(DECODE_STEPS)
        decode_wall_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=acts) as prof:
            steps(2 * DECODE_STEPS)
        dec = device_kernels(prof)

    def summary(kernels, wall_ms):
        busy = sum(k[0] for k in kernels)
        flash = sum(k[0] for k in kernels if "flash_fwd" in k[1])
        return {"wall_ms": wall_ms, "device_busy_ms": busy,
                "device_idle_share": 1.0 - busy / wall_ms,
                "flash_attention_ms": flash,
                "flash_attention_share_of_busy": flash / busy,
                "kernel_launches": sum(k[2] for k in kernels),
                "top": [{"name": k[1][:90], "device_ms": k[0], "count": k[2]}
                        for k in kernels[:12]]}
    return {"phase": "profile_serving", "arch": cfg.name,
            "batch": prompts.shape[0], "prompt": s,
            "prefill": summary(pre, prefill_wall_s * 1e3),
            "decode_steps": DECODE_STEPS,
            "decode": summary(dec, decode_wall_ms)}


def profile_round_loop(sc) -> dict:
    """Device time by kernel over one run's round loop (setup excluded),
    from torch.profiler, beside the same loop's wall time measured without
    the profiler (whose host overhead would swell it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import async_engine, engine
    cfg = sc.to_flat()
    eng = async_engine if sc.strategy.is_async else engine
    state0, data = eng.setup(cfg, device=DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.simulate(cfg, device=DEV, state0=state0, data=data)
    wall_ms = (time.perf_counter() - t0) * 1e3   # ends in the history fetch
    on_card = DEV == "cuda"
    with profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_card else [])) as prof:
        eng.simulate(cfg, device=DEV, state0=state0, data=data)
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
            "use_pallas_kernels": cfg.use_pallas_kernels,
            "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": (1.0 - busy_ms / wall_ms) if wall_ms else None,
            "kernel_launches": sum(k[2] for k in kernels),
            "top": [{"name": k[1][:90], "device_ms": k[0], "count": k[2]}
                    for k in kernels[:15]]}


def plan_nbytes(plan) -> int:
    """Device bytes a contact plan holds (its tensors)."""
    import torch
    fields = (plan._asdict().values() if hasattr(plan, "_asdict")
              else vars(plan).values())
    return sum(t.numel() * t.element_size() for t in fields
               if isinstance(t, torch.Tensor))


@contextlib.contextmanager
def recording_runs(module=None):
    """Keeps what each ``simulate`` call of ``api.run`` on the engine
    ``module`` (default the sync engine) saw and returned, ``(data, final
    state, outputs)``: ``RunResult`` has the reference's fields, which
    carry no per-round ``did_global``."""
    from repro_torch.core import engine
    module = module or engine
    seen, simulate = [], module.simulate

    def recorded(*args, **kwargs):
        state, outs = simulate(*args, **kwargs)
        seen.append((kwargs["data"], state, outs))
        return state, outs
    module.simulate = recorded
    try:
        yield seen
    finally:
        module.simulate = simulate


def due_rounds(did_global, rounds: int, every: int) -> int:
    """Rounds on which a gated stage-2 is due: on cadence, and every
    round while one is pending (the engine's host reads)."""
    pending, due = False, 0
    for rnd in range(rounds):
        if (rnd + 1) % every == 0 or pending:
            due += 1
            pending = not did_global[rnd]
    return due


def check_contact_plan() -> dict:
    """The full contact plan at N = 800 (25 planes of 32 at 1300 km, one
    orbital period at dt = 60 s): build seconds and peak memory, table
    bytes, visibility and reachability; two samples' PS-like rows held
    against the K-source relaxation (another algorithm: Bellman-Ford rows
    instead of (min,+) squaring), and one sample's closure timed beside
    one (min,+) product and that product's bound."""
    import torch
    from repro_torch.core.engine import _constellation_for
    from repro_torch.orbits import contact, topology
    from repro_torch.orbits.links import LinkParams, time_per_bit
    c, lp = _constellation_for(CONTACT_N), LinkParams()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    plan = contact.build_contact_plan(c, lp, device=DEV)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    peak_mb = (torch.cuda.max_memory_allocated() - base) / 1e6
    t_n, n = plan.gs_visible.shape
    finite = int(torch.isfinite(plan.isl_tpb).sum())
    src = torch.tensor([0, n // 4 + 11, n // 2 + 3, n - 1], device=DEV)
    worst = 0.0
    for i in (0, t_n // 2):
        pos = c.positions(plan.times[i])
        rows = topology.route_rows_time_per_bit(pos, src, lp, 8000.0, 8)
        want = plan.isl_tpb[i][src]
        assert torch.equal(torch.isfinite(rows), torch.isfinite(want))
        fin = torch.isfinite(want)
        err = float(((rows - want).abs() / want.clamp_min(1e-30))[fin].max())
        assert err <= TRAJ_RTOL, err
        worst = max(worst, err)
    pos = c.positions(plan.times[1])
    d = topology.pairwise_dist_km(pos)
    w = topology._reflexive(topology.isl_adjacency(pos, 8000.0),
                            time_per_bit(d, lp))
    n_ops, n_bytes = 2 * n ** 3, 3 * 4 * n * n
    bound_ms = max(n_ops / F32_FLOPS, n_bytes / HBM_BYTES_PER_S) * 1e3
    out = {
        "phase": "contact_plan", "num_sats": n, "samples": t_n,
        "dt_s": float(plan.times[1] - plan.times[0]),
        "build_s": build_s, "build_peak_device_mem_mb": peak_mb,
        "table_bytes": plan_nbytes(plan),
        "mean_gs_visible": float(plan.gs_visible.sum(1).float().mean()),
        "reachable_pair_share": (finite - t_n * n) / (t_n * n * (n - 1)),
        "rows_vs_closure_max_rel_err": worst,
        "sample_closure_ms": call_ms(
            lambda: topology.route_time_per_bit(pos, lp, 8000.0, 8),
            samples=5, warmup=1),
        "min_plus_product_ms": call_ms(
            lambda: topology._min_plus_mul(w, w), samples=5, warmup=1),
        "min_plus_product_bound_ms": bound_ms,
        "min_plus_chunk_bytes": topology.MIN_PLUS_CHUNK_BYTES,
    }
    del plan, w, d
    gc.collect()
    torch.cuda.empty_cache()
    return out


def synchronizing_calls(fn) -> list:
    """Run ``fn`` with the CUDA runtime's sync debug mode on: the calls it
    reports as synchronizing, each as the innermost port frame (file:line)
    that asked."""
    import torch
    syncs = []

    def seen(message, category, filename, lineno, *_):
        if "synchroniz" in str(message):
            port = [f for f in traceback.extract_stack()
                    if "repro_torch" in f.filename]
            f = port[-1] if port else None
            syncs.append(f"{Path(f.filename).name}:{f.lineno}" if f
                         else f"{Path(filename).name}:{lineno}")
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = seen
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return syncs


def contact_phase(scenario) -> dict:
    """fedspace and isl-onboard through ``api.run`` at N = 800, K = 4, 10
    rounds of 4 minutes on the full plan, kernels on and off in turns; then
    fedspace on the sliced and the factorized plan.  Each run: 10 launches
    of each kernel with the kernels on and none off, one host read per
    due round; on equals off, and sliced and factorized equal full."""
    import torch
    from repro_torch import api
    from repro_torch.core import engine
    from repro_torch.kernels import ops
    runs = {}

    def one(key, method, use, **comms):
        ops.reset_launches()
        engine.reset_host_reads()
        with recording_runs() as seen:
            res = api.run(scenario(method, CONTACT_N, use, comms=comms,
                                   round_minutes=4.0), device=DEV)
        data, state, outs = seen[-1]
        launches, reads = dict(ops.LAUNCHES), dict(engine.HOST_READS)
        check_result(res, 10, 5)
        assert res.global_rounds >= 1, res.global_rounds
        want = 10 if use else 0
        assert launches["kmeans_assign"] == want, launches
        assert launches["weighted_agg_multi"] == want, launches
        assert reads == {"window": due_rounds(outs.did_global, 10, 5),
                         "recluster": 0, "stage2": 0}, reads
        runs[key] = (res, outs.did_global.tolist(), state.pending_global)
        line = {"method": method, "kernels": use, **comms,
                "plan": type(data.plan).__name__,
                "plan_bytes": plan_nbytes(data.plan),
                "run_s_per_round": res.run_s / 10, "setup_s": res.setup_s,
                "peak_device_mem_mb": res.peak_device_mem_mb,
                "did_global": outs.did_global.tolist(),
                "global_rounds": res.global_rounds,
                "pending_global_at_end": state.pending_global,
                "host_reads": reads, "launches": launches,
                "acc": res.acc.tolist(), "loss": res.loss.tolist(),
                "time_s": res.time_s.tolist(),
                "energy_j": res.energy_j.tolist()}
        # the next run's peak memory must not count this run's tensors
        del data, state, outs, seen
        gc.collect()
        torch.cuda.empty_cache()
        return line

    def same(a, b):
        (ra, da, pa), (rb, db, pb) = runs[a], runs[b]
        assert da == db and pa == pb, (a, b, da, db, pa, pb)
        for key, rtol in (("time_s", TRAJ_RTOL), ("energy_j", TRAJ_RTOL),
                          ("loss", LOSS_RTOL)):
            x, y = getattr(ra, key), getattr(rb, key)
            assert all(abs(u - v) <= rtol * abs(v) for u, v in zip(x, y)), \
                (a, b, key, x, y)

    lines = [one(f"{m}/{use}", m, use) for m in ("fedspace", "isl-onboard")
             for use in (True, False)]
    for m in ("fedspace", "isl-onboard"):
        same(f"{m}/True", f"{m}/False")
    for layout in ("contact_slices", "contact_factorized"):
        lines.append(one(layout, "fedspace", True, **{layout: True}))
        same(layout, "fedspace/True")
    # the engine's host reads against what the CUDA runtime reports as
    # synchronizing (with the Python line that asked), over the round loop
    # of one fedspace run
    cfg = runs["fedspace/True"][0].scenario.to_flat()
    state0, data = engine.setup(cfg, device=DEV)
    engine.reset_host_reads()
    syncs = synchronizing_calls(
        lambda: engine.simulate(cfg, device=DEV, state0=state0, data=data))
    return {"phase": "contact", "num_clients": CONTACT_N, "num_clusters": 4,
            "rounds": 10, "round_minutes": 4.0, "runs": lines,
            "sync_check": {"host_reads": dict(engine.HOST_READS),
                           "synchronizing_calls": syncs},
            "order": "fedspace on, off; isl-onboard on, off; fedspace "
                     "sliced, factorized (kernels on)"}



def hold(a, b, what) -> None:
    """The golden bar between two runs' eval points: re-clusters, global
    rounds and eval rounds exact, time and energy rtol 1e-5, loss rtol
    1e-3, accuracy atol 5e-3.  ``a`` and ``b`` are dicts of arrays."""
    import numpy as np
    for key in ("round", "reclusters", "global_rounds"):
        assert np.array_equal(a[key], b[key]), (what, key, a[key], b[key])
    for key, rtol in (("time_s", TRAJ_RTOL), ("energy_j", TRAJ_RTOL),
                      ("loss", LOSS_RTOL)):
        x, y = np.asarray(a[key], float), np.asarray(b[key], float)
        assert np.all(np.abs(x - y) <= rtol * np.abs(y)), (what, key, x, y)
    x, y = np.asarray(a["acc"], float), np.asarray(b["acc"], float)
    assert np.all(np.abs(x - y) <= ACC_ATOL), (what, "acc", x, y)


def run_points(res) -> dict:
    """A ``RunResult``'s eval points for :func:`hold`."""
    return {"round": res.round, "acc": res.acc, "loss": res.loss,
            "time_s": res.time_s, "energy_j": res.energy_j,
            "reclusters": res.reclusters,
            "global_rounds": res.global_rounds}


def sweep_points(sweep, i: int) -> dict:
    """Seed ``i`` of a ``SweepResult`` as :func:`run_points` gives a run."""
    return {"round": sweep.eval_rounds,
            **{k: sweep.eval_curves(k)[i]
               for k in ("acc", "loss", "time_s", "energy_j")},
            "reclusters": int(sweep.reclusters[i]),
            "global_rounds": int(sweep.global_rounds[i])}


def stage1_bytes(c: int, k: int, leaves, esize: int) -> int:
    """A stage-1's bytes, each moved once: the stack and the outputs in
    the stack's dtype, the (C, K) weights in f32."""
    return sum(esize * (c * p + k * p) for p in leaves) + 4 * c * k


def wagg_k_phase(gen) -> dict:
    """``weighted_agg_multi`` past its old limits, at the main path's C =
    800 over LeNet's 10 leaves: K = 4 (the main path, again), 17 and 32
    (passes of 16 clusters) in f32 and bf16, each against plain and the
    same bits from two calls, timed beside its byte bound, the plain
    version and 10 ``torch.matmul``s; a tree of 65
    leaves (two launches); then fedhc through ``api.run`` at N = 800 with
    K = 17 and 32, kernels on against off at the golden bar."""
    import torch
    from repro_torch import api
    from repro_torch.api import ExecSpec, FleetSpec, Scenario, TrainSpec
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import weighted_agg as _wagg
    leaves, c = lenet_leaf_sizes(), CONTACT_N
    rows = []

    def check(got, stacks, w, tol):
        err = 0.0
        for g, x in zip(got, stacks):
            want = ref.weighted_agg_multi_ref(x, w)
            assert g.shape == want.shape and g.dtype == x.dtype
            torch.testing.assert_close(g.float(), want.float(), rtol=tol,
                                       atol=tol)
            err = max(err, float((g.float() - want.float()).abs().max()))
        return err

    for k in (4, 17, 32):
        for dt in (torch.float32, torch.bfloat16):
            stacks = tuple(torch.randn((c, p), generator=gen,
                                       device=DEV).to(dt) for p in leaves)
            w = engine_weights(c, k, gen)
            wt = w.T.contiguous().to(dt)
            tol = WAGG_TOL if dt == torch.float32 else WAGG_TOL_BF16
            esize = stacks[0].element_size()
            n_bytes = stage1_bytes(c, k, leaves, esize)
            n_ops = sum(2 * c * k * p for p in leaves)
            row = {"C": c, "K": k, "dtype": str(dt)[6:],
                   "bound_ms": max(n_bytes / HBM_BYTES_PER_S,
                                   n_ops / F32_FLOPS) * 1e3,
                   "bound_by": ("bytes" if n_bytes / HBM_BYTES_PER_S
                                >= n_ops / F32_FLOPS else "operations"),
                   "plain_ms": device_ms(
                       lambda: [ref.weighted_agg_multi_ref(x, w)
                                for x in stacks]),
                   "library_ms": device_ms(
                       lambda: [torch.matmul(wt, x) for x in stacks])}
            before = ops.LAUNCHES["weighted_agg_multi"]
            got = ops.weighted_agg_multi_tree(stacks, w)
            torch.cuda.synchronize()
            assert ops.LAUNCHES["weighted_agg_multi"] == before + 1
            row["max_abs_err"] = check(got, stacks, w, tol)
            row["ms"] = device_ms(lambda: ops.weighted_agg_multi_tree(
                stacks, w))
            again = ops.weighted_agg_multi_tree(stacks, w)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(got, again))
            pl = _wagg.plan_grouped(leaves, c, k, dt,
                                    [_wagg._aligned(x) for x in stacks])
            row.update(kmax=pl.kmax, passes=pl.passes, blocks=pl.blocks)
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
            rows.append(row)
            del stacks, got
    out = {"phase": "wagg_k", "stage1": rows}

    # 65 leaves: LeNet's 10 six times and 5 more, C = 800 (0.93 GB in f32)
    ps = (leaves * 7)[:_wagg.MAX_LEAVES + 1]
    for dt in (torch.float32, torch.bfloat16):
        stacks = tuple(torch.randn((c, p), generator=gen, device=DEV).to(dt)
                       for p in ps)
        w = engine_weights(c, 4, gen)
        before = ops.LAUNCHES["weighted_agg_multi"]
        got = ops.weighted_agg_multi_tree(stacks, w)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["weighted_agg_multi"] == before + 2
        tol = WAGG_TOL if dt == torch.float32 else WAGG_TOL_BF16
        n_bytes = stage1_bytes(c, 4, ps, stacks[0].element_size())
        wt = w.T.contiguous().to(dt)
        out[f"leaves_65_{str(dt)[6:]}"] = {
            "leaves": len(ps), "launches": 2,
            "max_abs_err": check(got, stacks, w, tol),
            "ms": device_ms(lambda: ops.weighted_agg_multi_tree(stacks, w),
                            reps=5),
            "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
            "library_ms": device_ms(
                lambda: [torch.matmul(wt, x) for x in stacks], reps=5)}
        del stacks, got
    gc.collect()
    torch.cuda.empty_cache()

    # the engine at K = 17 and 32: fedhc at N = 800, kernels on and off
    runs = {}
    for k in (17, 32):
        for use in (True, False):
            sc = Scenario(method="fedhc",
                          fleet=FleetSpec(num_clients=CONTACT_N,
                                          num_clusters=k,
                                          round_minutes=4.0,
                                          dropout_threshold=0.2),
                          train=TrainSpec(rounds=10, eval_every=5),
                          exec=ExecSpec(use_pallas_kernels=use))
            ops.reset_launches()
            res = api.run(sc, device=DEV)
            launches = dict(ops.LAUNCHES)
            check_result(res, 10, 5)
            want = 10 + res.reclusters if use else 0
            assert launches["weighted_agg_multi"] == want, launches
            assert launches["kmeans_assign"] == (10 if use else 0), launches
            runs[(k, use)] = res
            out[f"fedhc_K{k}_{'on' if use else 'off'}"] = {
                "launches": launches, "reclusters": res.reclusters,
                "run_s_per_round": res.run_s / 10, "acc": res.acc.tolist(),
                "loss": res.loss.tolist(), "time_s": res.time_s.tolist(),
                "peak_device_mem_mb": res.peak_device_mem_mb}
        hold(run_points(runs[(k, True)]), run_points(runs[(k, False)]),
             f"fedhc K={k} on vs off")
    return out


def sweep_phase(tmp: Path) -> dict:
    """``run_sweep`` at the paper's 800 satellites: fedhc over seeds 17-19
    (the re-cluster branch on), each seed held against ``api.run`` on it;
    fedspace over the same seeds on one full contact plan, its build
    counted and timed beside three ``api.run`` setups (each builds one);
    the five paper methods on the ``MNIST_K4`` preset with their time to
    ``TARGETS["mnist-like"]``; a ``RunResult`` and a ``SweepResult`` saved
    and loaded."""
    import dataclasses
    import numpy as np
    from repro_torch import api
    from repro_torch.api import ExecSpec, FleetSpec, Scenario, TrainSpec
    from repro_torch.configs.fedhc_paper import MNIST_K4, TARGETS
    from repro_torch.kernels import ops
    from repro_torch.orbits import contact
    out = {"phase": "sweep", "seeds": list(SWEEP_SEEDS)}

    def scenario(method):
        return Scenario(method=method,
                        fleet=FleetSpec(num_clients=CONTACT_N, num_clusters=4,
                                        round_minutes=4.0,
                                        dropout_threshold=0.2),
                        train=TrainSpec(rounds=10, eval_every=5),
                        exec=ExecSpec(use_pallas_kernels=True))

    builds, build = [], contact.build_contact_plan

    def timed_build(*args, **kwargs):
        t0 = time.perf_counter()
        plan = build(*args, **kwargs)
        builds.append(time.perf_counter() - t0)
        return plan
    contact.build_contact_plan = timed_build
    try:
        for method in ("fedhc", "fedspace"):
            sc = scenario(method)
            builds.clear()
            ops.reset_launches()
            sweep = api.run_sweep(sc, SWEEP_SEEDS, device=DEV)
            launches = dict(ops.LAUNCHES)
            sweep_builds = list(builds)
            n = len(SWEEP_SEEDS)
            assert launches["kmeans_assign"] == 10 * n, launches
            assert launches["weighted_agg_multi"] == 10 * n + int(
                sweep.reclusters.sum()), launches
            assert len(sweep_builds) == (method == "fedspace"), sweep_builds
            singles = []
            for i, seed in enumerate(SWEEP_SEEDS):
                res = api.run(sc.replace(seed=seed), device=DEV)
                hold(sweep_points(sweep, i), run_points(res),
                     f"{method} sweep seed {seed} vs api.run")
                singles.append(res)
            out[method] = {
                "wall_s": sweep.wall_s, "launches": launches,
                "plan_builds": len(sweep_builds),
                "plan_build_s": sweep_builds,
                "api_run_setup_s": [r.setup_s for r in singles],
                "api_run_s": [r.run_s for r in singles],
                "reclusters": sweep.reclusters.tolist(),
                "global_rounds": sweep.global_rounds.tolist(),
                "final_acc": sweep.final_acc.tolist()}
    finally:
        contact.build_contact_plan = build

    # the paper preset (N = 32, K = 4), rounds cut, one seed
    presets = {}
    t0 = time.perf_counter()
    for method in PAPER_METHODS:
        cfg = dataclasses.replace(MNIST_K4, method=method,
                                  rounds=PRESET_ROUNDS,
                                  use_pallas_kernels=True)
        res = api.run(cfg.to_scenario(), device=DEV)
        check_result(res, PRESET_ROUNDS, cfg.eval_every)
        tta = res.time_to_accuracy(TARGETS["mnist-like"])
        presets[method] = {
            "final_acc": res.final_acc, "run_s": res.run_s,
            "time_to_accuracy": tta._asdict() if tta else "never"}
    out["mnist_k4"] = {"rounds": PRESET_ROUNDS,
                       "target": TARGETS["mnist-like"],
                       "seconds": time.perf_counter() - t0,
                       "methods": presets}

    # results saved on the card and loaded back
    res.save(str(tmp / "run.json"))
    back = api.RunResult.load(str(tmp / "run.json"))
    assert back.to_history() == res.to_history()
    assert back.scenario == res.scenario
    sweep.save(str(tmp / "sweep.json"))
    sback = api.SweepResult.load(str(tmp / "sweep.json"))
    for key in ("acc", "loss", "time_s", "energy_j", "evaluated"):
        assert np.array_equal(getattr(sback, key),
                              np.asarray(getattr(sweep, key), float
                                         if key != "evaluated" else bool),
                              equal_nan=key != "evaluated"), key
    out["save_load"] = "ok"
    return out


def async_phase() -> dict:
    """The async event engine at N = 800, K = 4, cohorts of 200 and
    buffers of 50 (fedbuff: 200), the polynomial schedule, 40 events,
    kernels on and off in turns (fedspace-async on the full contact
    plan): one stage-1 launch an event on, none off, on equal to off at
    the golden bar with the per-event stage-2 firings and flushes exact;
    then the full cohort (800, constant) against the sync engine."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.api import (AsyncSpec, ExecSpec, FleetSpec, Scenario,
                                 TrainSpec)
    from repro_torch.core import async_engine, engine
    from repro_torch.core import strategies as strat_lib
    from repro_torch.kernels import ops

    cohort = CONTACT_N // 4

    def scenario(method, use, cohort=cohort, buffer=cohort // 4,
                 staleness="polynomial", events=ASYNC_EVENTS):
        return Scenario(method=method,
                        fleet=FleetSpec(num_clients=CONTACT_N, num_clusters=4,
                                        round_minutes=4.0),
                        train=TrainSpec(rounds=events, eval_every=10,
                                        rounds_per_global=5),
                        async_=AsyncSpec(cohort=cohort, buffer=buffer,
                                         staleness=staleness),
                        exec=ExecSpec(use_pallas_kernels=use))
    lines, runs = [], {}
    for method in ASYNC_METHODS:
        cache = {}
        for use in (True, False):
            buffer = cohort if method == "fedbuff" else cohort // 4
            ops.reset_launches()
            engine.reset_host_reads()
            with recording_runs(async_engine) as seen:
                res = api.run(scenario(method, use, buffer=buffer),
                              device=DEV, setup_cache=cache)
            launches, reads = dict(ops.LAUNCHES), dict(engine.HOST_READS)
            _, state, outs = seen[-1]
            check_result(res, ASYNC_EVENTS, 10)
            assert launches["weighted_agg_multi"] == (
                ASYNC_EVENTS if use else 0), launches
            assert launches["kmeans_assign"] == 0, launches
            assert reads["window"] == reads["recluster"] == 0, reads
            if method == "fedbuff":
                assert reads["stage2"] == 0, reads
            runs[(method, use)] = (res, outs.did_global.tolist(),
                                   outs.flushes.tolist())
            lines.append({
                "method": method, "kernels": use, "cohort": cohort,
                "buffer": buffer, "events": ASYNC_EVENTS,
                "s_per_event": res.run_s / ASYNC_EVENTS,
                "setup_s": res.setup_s, "flushes": res.flushes,
                "mean_staleness": res.mean_staleness,
                "global_rounds": res.global_rounds,
                "pending_global_at_end": state.pending_global,
                "host_reads": reads, "launches": launches,
                "peak_device_mem_mb": res.peak_device_mem_mb,
                "acc": res.acc.tolist(), "time_s": res.time_s.tolist(),
                "energy_j": res.energy_j.tolist()})
            del seen, state, outs
        (a, da, fa), (b, db, fb) = runs[(method, True)], runs[(method, False)]
        assert da == db and fa == fb, (method, da, db, fa, fb)
        hold(run_points(a), run_points(b), f"{method} on vs off")
        del cache
        gc.collect()
        torch.cuda.empty_cache()
    # the full cohort and the constant schedule: the sync engine's run
    twin = "fedhc-async-synctwin"
    if twin not in strat_lib.names():
        strat_lib.register(dataclasses.replace(
            strat_lib.get("fedhc-async"), name=twin, aggregation="sync"))
    full = api.run(scenario("fedhc-async", True, cohort=CONTACT_N,
                            buffer=CONTACT_N,
                            staleness="constant", events=10),
                   device=DEV)
    sync = api.run(scenario(twin, True, events=10), device=DEV)
    hold(run_points(full), run_points(sync), "full cohort vs sync")
    assert full.flushes == 40 and full.mean_staleness == 0.0, full.flushes
    return {"phase": "async", "num_clients": CONTACT_N, "num_clusters": 4,
            "runs": lines,
            "full_cohort_vs_sync": {
                "events": 10, "global_rounds": full.global_rounds,
                "time_s": full.time_s.tolist(),
                "sync_time_s": sync.time_s.tolist(),
                "acc": full.acc.tolist(), "sync_acc": sync.acc.tolist()},
            "order": "per method: on, off (one setup)"}


def series_vs_history(res) -> dict:
    """A telemetry-on ``RunResult``'s per-round series against its own
    history: stage-2 firings, re-clusters and (async) flushes sum to the
    totals, and ``t_round_s`` and the energy split cumulate to ``time_s``
    and ``energy_j`` at the eval points (rtol 1e-5)."""
    import numpy as np
    r = res.telemetry.rounds
    assert int(r["did_global"].sum()) == res.global_rounds, r["did_global"]
    assert int(r["reclustered"].sum()) == res.reclusters, r["reclustered"]
    if res.flushes is not None:
        assert int(r["flushes"].sum()) == res.flushes, r["flushes"]
    idx = res.round - 1
    t = np.cumsum(r["t_round_s"].astype(np.float64))[idx]
    e = np.cumsum(r["e_compute_j"].astype(np.float64)
                  + r["e_comm_j"].astype(np.float64))[idx]
    t_err = float(np.max(np.abs(t - res.time_s) / res.time_s))
    e_err = float(np.max(np.abs(e - res.energy_j) / res.energy_j))
    assert t_err <= TRAJ_RTOL and e_err <= TRAJ_RTOL, (t_err, e_err)
    return {"rounds": res.telemetry.num_rounds,
            "did_global": int(r["did_global"].sum()),
            "reclustered": int(r["reclustered"].sum()),
            "flushes": int(r["flushes"].sum()),
            "accepted_mean": float(r["accepted"].mean()),
            "stale_max": float(r["stale_max"].max()),
            "hops_mean": float(r["hops_mean"].mean()),
            "hops_max": float(r["hops_max"].max()),
            "e_compute_share": float(r["e_compute_j"].sum() / (
                r["e_compute_j"].sum() + r["e_comm_j"].sum())),
            "t_rel_err": t_err, "e_rel_err": e_err,
            "summary": res.telemetry.summary()}


def obs_phase(scenario) -> dict:
    """Flight telemetry at the paper's 800 satellites.  fedhc (K = 4, 10
    rounds of 4 minutes, Z = 0.2, kernels on) with telemetry off and on in
    turns, three runs each on one setup: histories equal with ``==`` (off
    against off first, then on against off), host reads, kernel launches
    and the CUDA runtime's synchronizing calls equal on and off, median
    ``run_s`` on and off; fedspace and fedhc-async (cohort 200) with
    telemetry on, their series against their histories; one telemetry-on
    fedhc run under ``torch.profiler`` (device ms by ``fed_step/*``
    scope); the Chrome trace written under ``chiprun_out/`` and
    validated."""
    import dataclasses
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import api
    from repro_torch.api import AsyncSpec, ExecSpec, FleetSpec, Scenario
    from repro_torch.api import TrainSpec
    from repro_torch.core import engine
    from repro_torch.kernels import ops
    from repro_torch.obs.telemetry import load_chrome_trace

    drift = dict(round_minutes=4.0, dropout_threshold=0.2)
    base = scenario("fedhc", CONTACT_N, True, **drift)
    flavours = {tel: base.replace(exec=dataclasses.replace(
        base.exec, telemetry=tel)) for tel in (False, True)}
    cache, runs = {}, {False: [], True: []}
    for _ in range(3):
        for tel in (False, True):
            ops.reset_launches()
            engine.reset_host_reads()
            res = api.run(flavours[tel], device=DEV, setup_cache=cache)
            check_result(res, 10, 5)
            runs[tel].append((res, dict(ops.LAUNCHES),
                              dict(engine.HOST_READS)))
    # off against off first: the card's own determinism
    off0 = runs[False][0][0].to_history()
    off_equal = all(r.to_history() == off0 for r, _, _ in runs[False])
    on_equal = all(r.to_history() == off0 for r, _, _ in runs[True])
    if off_equal:
        assert on_equal, "telemetry on changed the fedhc history"
    else:            # the card is not bit-deterministic run to run
        for r, _, _ in runs[True]:
            hold(run_points(r), run_points(runs[False][0][0]),
                 "telemetry on vs off")
    work = {(tuple(sorted(l.items())), tuple(sorted(h.items())))
            for tel in runs for _, l, h in runs[tel]}
    assert len(work) == 1, work
    launches, reads = runs[True][0][1], runs[True][0][2]
    assert launches["kmeans_assign"] == 10, launches
    assert launches["weighted_agg_multi"] == 10 + runs[True][0][0].reclusters

    # the CUDA runtime's synchronizing calls over the round loop, off, on
    # and off again (the first call under the debug mode adds a one-time
    # synchronizing call of its own): on makes as many as off
    state0, data = cache[next(iter(cache))]
    syncs = [synchronizing_calls(lambda: engine.simulate(
        flavours[tel].to_flat(), device=DEV, state0=state0, data=data))
        for tel in (False, True, False)]
    assert len(syncs[1]) == len(syncs[2]), syncs

    def stats(tel):
        s = [r.run_s / 10 for r, _, _ in runs[tel]]
        return {"run_s_per_round": s, "median": statistics.median(s),
                "peak_device_mem_mb": [r.peak_device_mem_mb
                                       for r, _, _ in runs[tel]]}
    on_run = runs[True][0][0]
    out = {"phase": "obs", "method": "fedhc", "num_clients": CONTACT_N,
           "num_clusters": 4, "rounds": 10, **drift,
           "off_equals_off": off_equal, "on_equals_off": on_equal,
           "launches": launches, "host_reads": reads,
           "synchronizing_calls": {"off, on, off": syncs},
           "telemetry_off": stats(False), "telemetry_on": stats(True),
           "overhead": (stats(True)["median"] / stats(False)["median"]
                        - 1.0),
           "spans": on_run.telemetry.spans,
           "counters": on_run.telemetry.counters,
           "fedhc_series": series_vs_history(on_run),
           "order": "off, on (x3), one setup"}
    del runs, cache, state0, data
    gc.collect()
    torch.cuda.empty_cache()

    # fedspace on the 800-satellite contact plan and fedhc-async (cohort
    # 200): telemetry off then on, on one setup
    def off_on(sc, steps):
        cache, res = {}, []
        for tel in (False, True):
            res.append(api.run(sc.replace(exec=ExecSpec(
                use_pallas_kernels=True, telemetry=tel)), device=DEV,
                setup_cache=cache))
            check_result(res[-1], steps, sc.train.eval_every)
        assert res[1].to_history() == res[0].to_history(), sc.method
        return res[1], {"off": res[0].run_s / steps,
                        "on": res[1].run_s / steps}
    fedspace, out["fedspace_run_s_per_round"] = off_on(
        scenario("fedspace", CONTACT_N, True, round_minutes=4.0), 10)
    out["fedspace_series"] = series_vs_history(fedspace)
    assert out["fedspace_series"]["hops_max"] >= 1
    asyn, out["fedhc_async_run_s_per_event"] = off_on(Scenario(
        method="fedhc-async",
        fleet=FleetSpec(num_clients=CONTACT_N, num_clusters=4,
                        round_minutes=4.0),
        train=TrainSpec(rounds=ASYNC_EVENTS, eval_every=10,
                        rounds_per_global=5),
        async_=AsyncSpec(cohort=CONTACT_N // 4, buffer=CONTACT_N // 16)),
        ASYNC_EVENTS)
    out["fedhc_async_series"] = series_vs_history(asyn)

    # device time by fed_step scope: one telemetry-on fedhc run
    cfg = flavours[True].to_flat()
    state0, data = engine.setup(cfg, device=DEV)
    engine.simulate(cfg, device=DEV, state0=state0, data=data)   # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.simulate(cfg, device=DEV, state0=state0, data=data)
    # a scope's range on the host (record_function) and on the device
    # timeline (its GPU annotation: first to last kernel in the range; the
    # backward kernels the autograd thread launches fall inside it), beside
    # the device time of the kernels the host range launched itself
    cuda = torch.autograd.DeviceType.CUDA
    scopes, busy_us = {}, 0.0
    for e in prof.key_averages():
        if not e.key.startswith("fed_step/"):
            busy_us += e.self_device_time_total if e.device_type == cuda \
                else 0.0
            continue
        side = "device" if e.device_type == cuda else "host"
        scopes.setdefault(e.key, {})[side] = {
            "count": e.count,
            "range_ms": (e.self_device_time_total if side == "device"
                         else e.cpu_time_total) / 1e3,
            "launched_kernels_ms": e.device_time_total / 1e3}
    assert set(scopes) == {"fed_step/local_train", "fed_step/aggregate",
                           "fed_step/telemetry"}, scopes
    out["profile_scopes"] = scopes
    out["profile_device_busy_ms"] = busy_us / 1e3

    # the Chrome trace of the telemetry-on fedhc run
    trace_path = ROOT / "chiprun_out" / "obs_fedhc_trace.json"
    on_run.telemetry.save_chrome_trace(str(trace_path))
    trace = load_chrome_trace(str(trace_path))
    out["chrome_trace"] = {"path": str(trace_path.relative_to(ROOT)),
                           "events": len(trace["traceEvents"])}
    del state0, data, prof
    gc.collect()
    torch.cuda.empty_cache()
    return out


# the fleet phase's grid: the paper's methods at 800 satellites over K and
# seeds (fig. 3's axes), every cell a 10-round run with the kernels on
FLEET_GRID = {
    "name": "chip-smoke-fleet",
    "base": {"fleet.num_clients": CONTACT_N, "fleet.round_minutes": 4.0,
             "fleet.dropout_threshold": 0.2, "train.rounds": 10,
             "train.eval_every": 5, "exec.use_pallas_kernels": True},
    "axes": [{"path": "method",
              "values": ["fedhc", "h-base", "c-fedavg", "fedspace"]},
             {"path": "fleet.num_clusters", "values": [3, 4]},
             {"path": "seed", "values": [17, 18]}],
}


def fleet_phase(tmp: Path) -> dict:
    """The fleet sweep service at N = 800: :data:`FLEET_GRID` run through
    ``fleet.run_grid`` into a fresh store (one seed sweep a class, one
    contact plan a fedspace class, c-fedavg deduplicated across K), every
    cell held at the golden bar against its own ``api.run``; the same grid
    again (nothing runs); the report CLI's first lines."""
    import io
    import shutil
    from repro_torch import api
    from repro_torch.fleet import SweepGrid, plan_grid, run_grid
    from repro_torch.kernels import ops
    from repro_torch.obs.report import main as report_main
    from repro_torch.obs.trace import COUNTERS, Counters

    grid = SweepGrid.from_dict(FLEET_GRID)
    plan = plan_grid(grid)
    base = tmp / "sweeps"
    shutil.rmtree(base, ignore_errors=True)
    ops.reset_launches()
    c0 = COUNTERS.snapshot()
    t0 = time.perf_counter()
    store, report = run_grid(grid, str(base), device=DEV, verbose=False)
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    d = Counters.delta(c0, COUNTERS.snapshot())
    cells = store.load_all()
    runs = sum(len(c.jobs) for c in plan.classes)
    gated = sum(c.cells[0].scenario.strategy.visibility_gated
                for c in plan.classes)
    assert report["cells_run"] == len(plan.cells) == 16, report
    assert d.get("fleet.cells.deduped", 0) == len(plan.cells) - runs == 2, d
    assert d.get("engine.plan_cache.miss", 0) == gated == 2, d
    # the kernels: 10 drift checks and 10 stage-1s a federated run, and a
    # stage-1 a re-cluster; c-fedavg runs neither
    fed_jobs = [sc for c in plan.classes for sc in c.jobs.values()
                if not sc.strategy.centralized]
    recl = sum(r.reclusters for r in
               {c.cell_jobs[x.key]: cells[x.key] for c in plan.classes
                for x in c.cells}.values())
    assert launches["kmeans_assign"] == 10 * len(fed_jobs), launches
    assert launches["weighted_agg_multi"] == 10 * len(fed_jobs) + recl, \
        launches
    for key, res in cells.items():
        single = api.run(res.scenario, device=DEV)
        hold(run_points(res), run_points(single),
             f"fleet cell {res.scenario.method} K="
             f"{res.scenario.fleet.num_clusters} seed={res.scenario.seed}")

    t0 = time.perf_counter()
    _, again = run_grid(grid, str(base), device=DEV, verbose=False)
    resume_s = time.perf_counter() - t0
    assert again["cells_run"] == 0 and again["cells_skipped"] == 16, again
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert report_main([store.root]) == 0
    return {"phase": "fleet", "grid_hash": grid.grid_hash(),
            "cells": len(plan.cells), "classes": len(plan.classes),
            "runs": runs, "deduped": d.get("fleet.cells.deduped", 0),
            "plan_builds": d.get("engine.plan_cache.miss", 0),
            "plan_reuses": d.get("engine.plan_cache.hit", 0),
            "launches": launches, "reclusters": recl, "wall_s": wall,
            "per_class": [{"label": e["label"], "mode": e["mode"],
                           "run": e["run"], "wall_s": e["wall_s"],
                           "per_round_s": e["per_round_s"],
                           "counters": e["counters"]}
                          for e in report["classes"]],
            "resume": {"cells_run": again["cells_run"],
                       "cells_skipped": again["cells_skipped"],
                       "wall_s": resume_s},
            "report_head": buf.getvalue().splitlines()[:14]}


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
    from repro_torch.api import (AsyncSpec, CommsSpec, ExecSpec, FleetSpec,
                                 Scenario, TrainSpec)
    from repro_torch.configs import get_config, replace
    from repro_torch.kernels import build, ops
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import init_params, param_count

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
          "sources": [f"src/repro_torch/csrc/{s}.cu" for s in build.SOURCES],
          "ptxas": {src: [short_kernel_name(k) for k in build.ptxas_info(src)]
                    for src in build.SOURCES}})

    # ---- 3. kernels vs plain on the card ---------------------------------
    gen = torch.Generator(device=DEV).manual_seed(11)
    wagg = check_weighted_agg(gen)
    km = check_kmeans(gen)
    wagg1 = check_weighted_agg_single(gen)
    flash = check_flash(gen)
    emit({"phase": "kernels_vs_plain", "weighted_agg_multi": wagg,
          "kmeans_assign": km, "weighted_agg": wagg1,
          "flash_attention": flash, "launch_floor_ms": km["launch_floor_ms"]})
    gc.collect()            # the checks' tensors and graphs: out of the
    torch.cuda.empty_cache()  # main path's peak-memory readings

    # ---- 4. main path --------------------------------------------------
    def scenario(method, n, use_kernels, comms=None, **fleet):
        return Scenario(method=method,
                        fleet=FleetSpec(num_clients=n, num_clusters=4,
                                        **fleet),
                        train=TrainSpec(rounds=10, eval_every=5),
                        comms=CommsSpec(**(comms or {})),
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
    # one grouped launch a stage-1: one a round, and one a re-cluster
    assert ops.LAUNCHES["weighted_agg_multi"] == 10 * len(fed) + n_recl, \
        ops.LAUNCHES
    emit({"phase": "paper_methods", "num_clients": 32, "num_clusters": 4,
          "rounds": 10, "launches": dict(ops.LAUNCHES), "runs": paper})

    # fedhc at the paper's 800 satellites, with the kernels and without,
    # in turns, three times each; 4-minute rounds and Z = 0.2 (the
    # reference's own kernel-flag parity setting) so the re-cluster branch
    # and its MAML hand-off run too
    drift = dict(round_minutes=4.0, dropout_threshold=0.2)
    runs = {True: [], False: []}
    for _ in range(3):
        for use in (True, False):
            ops.reset_launches()
            res = api.run(scenario("fedhc", 800, use, **drift), device=DEV)
            check_result(res, 10, 5)
            runs[use].append((res, dict(ops.LAUNCHES)))
    on, launches = runs[True][0]
    assert on.reclusters >= 1, on.reclusters
    for (a, counts), (b, off_counts) in zip(runs[True], runs[False]):
        assert set(off_counts.values()) == {0}, off_counts
        assert counts["kmeans_assign"] == 10, counts
        # one grouped launch a stage-1: one a round, and one a re-cluster
        assert counts["weighted_agg_multi"] == 10 + a.reclusters, counts
        assert a.reclusters == b.reclusters == on.reclusters, \
            (a.reclusters, b.reclusters)
        for key, rtol in (("time_s", TRAJ_RTOL), ("energy_j", TRAJ_RTOL),
                          ("loss", LOSS_RTOL)):
            x, y = getattr(a, key), getattr(b, key)
            assert all(abs(u - v) <= rtol * abs(v) for u, v in zip(x, y)), \
                (key, x, y)
    off = runs[False][0][0]

    def per_round(use):
        s = [r.run_s / 10 for r, _ in runs[use]]
        return {"run_s_per_round": s, "median": statistics.median(s),
                "spread": max(s) - min(s)}
    emit({"phase": "paper_scale", "method": "fedhc", "num_clients": 800,
          "num_clusters": 4, "rounds": 10, **drift,
          "launches": launches, "reclusters": on.reclusters,
          "kernels_on": {"acc": on.acc.tolist(), "loss": on.loss.tolist(),
                         "time_s": on.time_s.tolist(),
                         "energy_j": on.energy_j.tolist(),
                         "setup_s": on.setup_s, "compile_s": on.compile_s,
                         **per_round(True),
                         "peak_device_mem_mb": on.peak_device_mem_mb},
          "kernels_off": {"acc": off.acc.tolist(), "loss": off.loss.tolist(),
                          "time_s": off.time_s.tolist(),
                          "energy_j": off.energy_j.tolist(),
                          **per_round(False),
                          "peak_device_mem_mb": off.peak_device_mem_mb},
          "order": "on, off, on, off, on, off"})

    # ---- 5. where the time goes: fedhc at N = 800 under torch.profiler,
    # with the kernels and without
    for use in (True, False):
        emit(profile_round_loop(scenario("fedhc", 800, use, **drift)))

    # ---- 5b. contact plans and the visibility-gated engine at N = 800:
    # the plan alone, fedspace and isl-onboard through api.run, and one
    # fedspace run under torch.profiler
    emit(check_contact_plan())
    emit(contact_phase(scenario))
    emit(profile_round_loop(scenario("fedspace", CONTACT_N, True,
                                     round_minutes=4.0)))

    # ---- 5c. weighted_agg_multi at any K and beyond 64 leaves; seed
    # sweeps, the paper preset and result files; the async event engine,
    # and one fedhc-async run under torch.profiler
    wagg_k = wagg_k_phase(gen)
    emit(wagg_k)
    tmp = ROOT / "build" / "chip_smoke"
    tmp.mkdir(parents=True, exist_ok=True)
    emit(sweep_phase(tmp))
    emit(async_phase())
    emit(profile_round_loop(Scenario(
        method="fedhc-async",
        fleet=FleetSpec(num_clients=CONTACT_N, num_clusters=4,
                        round_minutes=4.0),
        train=TrainSpec(rounds=ASYNC_EVENTS, eval_every=10),
        async_=AsyncSpec(cohort=CONTACT_N // 4, buffer=CONTACT_N // 16),
        exec=ExecSpec(use_pallas_kernels=True))))
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 5d. flight telemetry and the fleet sweep service at N = 800
    emit(obs_phase(scenario))
    emit(fleet_phase(tmp))

    # ---- 6. serving: full gemma2-2b, prefill + greedy decode -------------
    del on, off, runs
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("gemma2-2b")
    sgen = torch.Generator(device=DEV).manual_seed(12)
    t0 = time.perf_counter()
    params = init_params(cfg, sgen)           # bf16, the config's dtype
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                            generator=sgen, device=DEV)
    ops.reset_launches()
    first = serve_batch(cfg, params, prompts, SERVE_TOKENS, device=DEV)
    serve_launches = dict(ops.LAUNCHES)
    serve_routes = dict(ops.FLASH_ROUTES)
    assert serve_launches["flash_attention"] == cfg.num_layers, serve_launches
    # every prefill layer on the tensor cores: 26 launches a prefill
    assert serve_routes == {"tensor_cores": cfg.num_layers,
                            "cuda_cores": 0}, serve_routes
    ops.reset_launches()
    second = serve_batch(cfg, params, prompts, SERVE_TOKENS, device=DEV)
    assert dict(ops.FLASH_ROUTES) == serve_routes, ops.FLASH_ROUTES
    for res in (first, second):
        assert res.tokens.shape == (SERVE_BATCH, SERVE_TOKENS)
        assert 0 <= int(res.tokens.min()) <= int(res.tokens.max()) \
            < cfg.vocab_size
    assert torch.equal(first.tokens, second.tokens), "greedy decode differs"
    emit({"phase": "serve", "arch": cfg.name, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "params": param_count(params),
          "dtype": cfg.dtype, "batch": SERVE_BATCH, "prompt": SERVE_PROMPT,
          "new_tokens": SERVE_TOKENS, "init_s": init_s,
          "launches": serve_launches, "flash_routes": serve_routes,
          "runs": [{"prefill_s": r.prefill_s, "decode_s": r.decode_s,
                    "decode_tokens_per_s": r.decode_tokens_per_s,
                    "peak_device_mem_mb": r.peak_device_mem_mb}
                   for r in (first, second)],
          "first_tokens": first.tokens[:, :8].tolist()})

    # ---- 7. prefill + decode == a longer prefill --------------------------
    consist = {}
    # bf16, full depth: 8191 prompt tokens, then token 8192
    bf16 = last_logits_consistency(cfg, params, prompts)
    assert bf16["max_abs_err"] <= CONSIST_TOL_BF16, bf16
    consist["bf16_26_layers"] = {**bf16, "tol": CONSIST_TOL_BF16,
                                 "prompt": SERVE_PROMPT - 1}
    # f32, full width, one local and one global layer: 4608 > 4096 tokens
    cfg32 = replace(cfg, num_layers=2, dtype="float32")
    p32 = init_params(cfg32, sgen)
    ops.reset_launches()
    f32 = last_logits_consistency(cfg32, p32, prompts[:, :4609])
    f32_routes = dict(ops.FLASH_ROUTES)     # two prefills of two layers
    assert f32_routes == {"tensor_cores": 0, "cuda_cores": 4}, f32_routes
    assert f32["max_abs_err"] <= CONSIST_TOL_F32, f32
    consist["f32_2_layers"] = {**f32, "tol": CONSIST_TOL_F32, "prompt": 4608,
                               "flash_routes": f32_routes}
    emit({"phase": "serve_consistency", **consist})
    del p32
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 8. where the time goes: a gemma2-2b prefill and decode steps
    emit(profile_serving(cfg, params, prompts, second.prefill_s))
    del params

    emit({"phase": "elapsed", "script_s": time.perf_counter() - T_START})

    # ---- 9. the kernels line ---------------------------------------------
    # no main path runs weighted_agg: both runs counted it at 0
    assert launches["weighted_agg"] == serve_launches["weighted_agg"] == 0, \
        (launches, serve_launches)
    # flash_attention's main path is the bf16 prefill (the tensor-core
    # kernel); its f32 route ran in the f32 consistency check
    launches["flash_attention"] = serve_routes["tensor_cores"]
    launches["flash_attention_f32"] = f32_routes["cuda_cores"]
    rows = []
    for kname, src, replaces, m in (
            ("weighted_agg_multi", "src/repro_torch/csrc/weighted_agg.cu",
             "src/repro/kernels/weighted_agg.py:76", wagg),
            ("kmeans_assign", "src/repro_torch/csrc/kmeans.cu",
             "src/repro/kernels/kmeans.py:35", km),
            ("weighted_agg", "src/repro_torch/csrc/weighted_agg.cu",
             "src/repro/kernels/weighted_agg.py:34", wagg1),
            ("flash_attention", "src/repro_torch/csrc/flash_attention_sm90.cu",
             "src/repro/kernels/flash_attention.py:88", flash),
            ("flash_attention_f32", "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:88", flash["f32_route"])):
        rows.append({"name": kname, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[kname],
                     "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                     "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                     "bound_by": m["bound_by"],
                     "library_ms": m["library_ms"], "shape": m["shape"]})
    # K > 16: the K = 32 stage-1 on the default route, launched by fedhc
    # at N = 800 with K = 32 (one a round and one a re-cluster)
    k32 = next(r for r in wagg_k["stage1"]
               if r["K"] == 32 and r["dtype"] == "float32")
    rows.append({"name": "weighted_agg_multi_k32", "route": "cuda",
                 "source": "src/repro_torch/csrc/weighted_agg.cu",
                 "replaces": "src/repro/kernels/weighted_agg.py:76",
                 "launches": wagg_k["fedhc_K32_on"]["launches"][
                     "weighted_agg_multi"],
                 **{key: k32[key] for key in (
                     "max_abs_err", "ms", "plain_ms", "bound_ms",
                     "bound_by", "library_ms")},
                 "shape": "one stage-1: 10 LeNet leaves, C=800, K=32, f32, "
                          "two passes of 16 clusters"})
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
