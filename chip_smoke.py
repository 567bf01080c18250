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
``api.run``; the grid resumed as a no-op), runs the client mesh at N =
800 (fedhc on a one-rank NCCL mesh equal with ``==`` to the unsharded
run, then fedhc, fedspace and fedhc-async on two spawned ranks that
share the card over gloo, each against its single-device run at the
sharded bar), serves the full
gemma2-2b (26 layers, bf16, random weights) through
``repro_torch.launch.serve.serve_batch`` with a prompt longer than its
4096-token window, checks prefill + decode against a longer prefill,
profiles one prefill, serves the recurrent families the same way at full
width and depth (mamba2-1.3b, 48 SSD layers; recurrentgemma-2b, whose 8
local layers go through the bf16 flash kernel, held at that shape in
``kernels_vs_plain``), with one decode step each at the published
``decode_32k`` and ``long_500k`` shapes, serves the mixtures of experts
at full width with their depth cut to fit the card (grok-1-314b at 4 of
64 layers with its int8 KV cache, mixtral-8x22b at 8 of 56 with its
4096-token window; the scan dispatch; every layer's prefill through the
bf16 flash kernel at D = 128, group 6, held in ``kernels_vs_plain`` as rows
4c and 4d), with one grok-1 decode step at ``decode_32k`` on a 2-layer
build, serves the front ends at full width and depth (whisper-large-v3:
B = 16 clips of 1500 frames encoded once, a 128-token prompt, 64 new
tokens, the encoder and the cross-attention of the prefill and of every
decode step through the bf16 flash kernel; pixtral-12b: 1024 patch
embeddings before 7168 text tokens, 32 new tokens), with flash launches
counted by shape and stage, prefill + decode against a longer prefill in
bf16 and on an f32 depth cut, and profiles of the encode, a prefill and
decode steps (flash at their shapes: rows 4e-4g of ``kernels_vs_plain``,
against SDPA), runs tensor parallelism over "model" (phase ``tp``):
qwen2-72b at full width with its depth cut to 4 layers served on a (1,
2) mesh (a prefill of B = 2 x 4096 tokens, 16 greedy decode steps) and
gemma2-2b at full width, 6 layers, trained one round on a (2, 2) mesh
(2 clients of TP 2), the ranks spawned processes sharing the card over
gloo, each against the same weights on one rank without a mesh, with
flash at one rank's heads (row 4h), runs the mesh program of the other
families the same way on a (1, 2) mesh (phase ``tp_families``):
grok-1-314b at full width and 2 layers (per-expert TP, B = 2 x 4096, the
held run fed one rank's routing; every token the mesh would have routed
apart must be a router near-tie), whisper-large-v3 at 4 + 4 layers (4
clips encoded on the mesh, cross-attention on a rank's heads) and
pixtral-12b at 4 layers
(1024 patches projected column-parallel), each a prefill and 8 decode
steps held against one rank, with flash at a rank's heads (grok-1's
layer, whisper's encoder and its cross-attention in decode), runs the
mesh program of the recurrent pair the same way on (1, 2) (phase
``tp_recurrent``): mamba2-1.3b at full width and 16 layers (the SSD by
heads) and recurrentgemma-2b at 8 (the RG-LRU by channels, its local
attention on a rank's heads), B = 2 x 4096, 8 decode steps each, with
flash at one rank's local layer (row 4l), and mamba2-1.3b in float32 (4
layers, held at 1e-3 of the logits: a mesh fault, not bf16 rounding),
trains
gemma2-2b at full width, 13 layers, through
``repro_torch.launch.train.train`` (4 clients stacked on the card, K = 2,
4096-token sequences, 3 rounds with stage-2 in round 2; round 1's stage-1
held against the plain version on its own stack and timed; one stage-1
launch a round; rounds 1-2 again with the kernels off), then mamba2-1.3b
(24 layers), recurrentgemma-2b (14) and whisper-large-v3 (8 + 8) at full
width the same way for 2 rounds (round 1 again with the
kernels off; one stage-1 launch a round for each dtype of their leaves),
then mixtral-8x22b at full width with its depth cut to 1 layer (phase
``train_moe``: 2 clients in 1 cluster, a global batch of 16, its
profile's bf16 accumulator and scan dispatch, 3 rounds as gemma2-2b),
dry-runs each of those serves and trainings and the tp, tp_families
and tp_recurrent runs on the host
(``repro_torch.launch.dryrun``, fake tensors, in worker processes that
count while the card trains) and holds its predicted peak within 0.5-2x
of the measured one, and prints one JSON line per phase.  The line
before the last is ``{"kernels": [...]}``, the last
``{"ok": true, "device": {...}}``.  Any failure raises: nothing is caught,
and the exit code is then not 0.  Without CUDA, or outside a checkout, it
exits with an error before printing any result.  It imports nothing of
JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import json
import math
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
# the reference's flash sweep (tests/test_kernels.py) and two cases of
# cross-attention: B, Hq, Hkv, Sq, Sk, D, causal, window, softcap
FLASH_CASES = [
    (1, 4, 2, 128, 128, 64, True, 0, 0.0),
    (2, 4, 4, 96, 96, 32, True, 0, 50.0),
    (1, 8, 2, 256, 256, 64, True, 64, 0.0),
    (1, 2, 1, 1, 300, 64, True, 0, 0.0),
    (1, 2, 1, 1, 300, 64, True, 128, 0.0),
    (1, 2, 2, 128, 128, 64, False, 0, 0.0),
    (2, 2, 2, 70, 70, 128, True, 0, 0.0),
    # cross-attention (whisper): non-causal, Sk = 1500 = 23 * 64 + 28
    (2, 4, 4, 100, 1500, 64, False, 0, 0.0),
    (2, 4, 4, 1, 1500, 64, False, 0, 0.0),
]
# transformer FL training (launch/train.py): gemma2-2b at full width and
# depth, C = 4 clients of 4 rows (4 microbatches of 1) at 4096 tokens, K = 2,
# stage-2 every 2 rounds, SGD at lr 0.01; the kernels-off rerun takes the
# first TRAIN_RERUN rounds from the same start and batches
TRAIN_ARCH, TRAIN_CLIENTS, TRAIN_CLUSTERS = "gemma2-2b", 4, 2
TRAIN_ROUNDS, TRAIN_RPG, TRAIN_BATCH, TRAIN_RERUN = 3, 2, 16, 2
# the recurrent families train the same way (their profiles: bf16
# parameters with f32 A_log/D/dt_bias and RG-LRU gates, f32 accumulation,
# remat; grad_accum 8 and 4, so 4 microbatches of 1 row), 2 rounds with
# stage-2 in round 2, round 1 again with the kernels off
REC_TRAIN_ROUNDS, REC_TRAIN_RERUN = 2, 1
# and so does whisper-large-v3 (bf16, grad_accum 8: 4 microbatches of 1
# row of 4096 tokens and 1500 frames a client; the frames 0.1 * normal,
# drawn each round by launch/train.py)
FRONTEND_TRAIN_ARCHS = ("whisper-large-v3",)
# every training run's depth is cut to about half, each pattern kept
# (gemma2-2b 26 -> 13: its leftover local layer; recurrentgemma-2b 26 ->
# 14: 4 cycles and its 2 leftover rglru layers; whisper-large-v3 32 + 32
# -> 8 + 8), to keep the script under the 1,200 s limit: on the hosts of
# two runs where nvcc took 2.2x as long as before and every host-bound
# phase 1.3-2x, the script took 1,264-1,285 s with these runs at full
# depth (whisper at 16 + 16), of which they took 444 s; each round is
# device time that falls with depth (gemma2-2b 17.3 s at 26 layers)
TRAIN_LAYERS = {"gemma2-2b": 13, "mamba2-1.3b": 24, "recurrentgemma-2b": 14,
                "whisper-large-v3": 8}
# mixture-of-experts FL training (phase train_moe): mixtral-8x22b at full
# width (d_model 6144, 48 heads of 128 over 8 kv heads, d_ff 16384, 8
# experts top-2, vocab 32768) in its own profile (bf16 parameters and
# gradient accumulator, scan dispatch, remat), C = 2 clients in K = 1
# cluster (stage-1 averages the two), train_4k's 4096 tokens, 3 rounds
# with stage-2 in round 2 and rounds 1-2 again with the kernels off, as
# gemma2-2b.  Memory allows 2 layers: the dry run (`launch.train
# --dry-run --clients 2 --clusters 1 --layers N`) counts 37.29 GB at 1
# layer, 64.93 at 2 and 94.98 at 3, and 2 layers at a global batch of 16
# (8 microbatches of 1 row a client) peaked at 66.3 GB on the card.  Time
# does not: that phase took 80 s, 50 more than at 1 layer, and the script
# would pass the 1,080 s it aims at on the slower hosts seen (1,264-1,285
# s before the other trainings' depths were cut; ~1,025 s estimated
# after), so the depth is cut 56 -> 1.  The global batch stays 16: 8
# rows a client, which the profile's grad_accum of 32 takes as 8
# microbatches of 1 row (at a global batch of 8 the phase took 28.6-30.2
# s)
MOE_TRAIN_ARCH, MOE_TRAIN_LAYERS = "mixtral-8x22b", 1
MOE_TRAIN_CLIENTS, MOE_TRAIN_CLUSTERS, MOE_TRAIN_BATCH = 2, 1, 16
# kernels on vs off, round 2's mean client CE: the two runs' round-1
# stage-1 outputs may differ by one bf16 ulp (2^-8 relative) in some
# elements, and round 2's forward rounds every activation to bf16 (8 bits)
# through 26 layers: 1e-2 relative, the bar of the CPU tests' bf16 round.
# That bar is wider than CE moves in three rounds, so the runs' client
# stacks after rounds 1 and 2 are held too, element by element: stage-1
# rounds an f32 sum to bf16 on both routes (the kernel's FMAs and the
# plain f32 matmul), so from the same local updates the two land within
# one bf16 ulp of each other
TRAIN_CE_RTOL = 1e-2
TRAIN_STACK_ULPS = 1.0
TRAIN_CHUNK = 1 << 26         # columns a plain stage-1 takes at once
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
# the recurrent families (phase serve_recurrent): mamba2-1.3b (48 SSD
# layers) and recurrentgemma-2b (8 cycles of rglru, rglru, local + 2 rglru),
# each at full width and depth in bf16, served as gemma2-2b is; then one
# pattern cycle in f32 (mamba2 2 layers, recurrentgemma 3) past the
# 2048-token window, and one decode step at the published decode shapes
RECURRENT_ARCHS = ("mamba2-1.3b", "recurrentgemma-2b")
RECURRENT_F32_LAYERS = {"mamba2-1.3b": 2, "recurrentgemma-2b": 3}
RECURRENT_F32_PROMPT = 2560   # > recurrentgemma's window 2048
RECURRENT_DECODE_SHAPES = ("decode_32k", "long_500k")
DECODE_SHAPE_STEPS = 5        # timed steps at each decode shape
# recurrentgemma's local layers: B, Hq, Hkv, S, D, window; no soft-cap
FLASH_RG_LOCAL = (SERVE_BATCH, 10, 1, SERVE_PROMPT, 256, 2048)
# prefill + decode against a longer prefill for the recurrent models.  f32
# over one cycle: the chunked SSD and the log-depth scan against their
# one-step recurrences differ by float32 rounding (~1e-5 on logits of rms
# ~1, measured on the CPU at full width), so the gemma2 bar, 1e-4, holds.
# bf16 at full depth: logits have rms ~1 and no cap; each side rounds
# activations to bf16 after differently ordered sums and the flips grow
# with depth (on the CPU, mamba2 at full width: max 0.058 / 0.186 / 0.257
# and rms 0.010 / 0.032 / 0.049 at 4 / 8 / 16 layers).  A stale state
# gives errors of the logits' own size (rms ~1.4).  So: max <= 1.0 and
# rms <= 0.25 of the logits' rms.
CONSIST_REC_MAX_BF16 = 1.0
CONSIST_REC_RMS_BF16 = 0.25
# the mixtures of experts (phase serve_moe): grok-1-314b and mixtral-8x22b
# at full width with their depth cut to fit the card (bf16: grok 4 of 64
# layers, 20.5e9 parameters; mixtral 8 of 56, 20.4e9), random weights,
# each with its profile's dispatch (scan) and KV cache (grok int8, mixtral
# bf16), served as gemma2-2b is; then one layer in f32 over MOE_F32_PROMPT
# + 1 tokens (past mixtral's 4096-token window), and one grok decode step
# at decode_32k on a MOE_DECODE_LAYERS-layer build
MOE_ARCHS = ("grok-1-314b", "mixtral-8x22b")
MOE_LAYERS = {"grok-1-314b": 4, "mixtral-8x22b": 8}
MOE_F32_PROMPT = 4097
MOE_DECODE_LAYERS = 2
# the MoE layers' attention: B, Hq, Hkv, S, D, window (causal, no soft-cap);
# rows 4c (grok-1) and 4d (mixtral)
FLASH_MOE = {"grok-1-314b": (SERVE_BATCH, 48, 8, SERVE_PROMPT, 128, 0),
             "mixtral-8x22b": (SERVE_BATCH, 48, 8, SERVE_PROMPT, 128, 4096)}
# prefill + decode against a longer prefill for the MoE models, fixed
# before their first run on the card (PERF.md section 6).  f32 on
# one layer with an unquantized cache: float32 rounding, the gemma2 bar
# 1e-4.  bf16 at the cut depth, and the int8 cache (against the longer
# prefill and against the same run with a bf16 cache): each side rounds
# activations to bf16 after differently ordered sums, the int8 cache adds
# up to amax / 254 an element to K and V (~0.6% rms), and a near tie of
# the router's bf16 logits may pick another expert for the last token in
# a layer: a different function of that token, not a broken cache, whose
# errors are the logits' own size (rms share ~1.4).  So: max <= 2.0 and
# rms <= 0.5 of the logits' rms
CONSIST_MOE_MAX = 2.0
CONSIST_MOE_RMS = 0.5
# the front ends (phase serve_frontend), at full width and depth in bf16,
# random weights and 0.1 * normal front-end inputs from a seed.
# whisper-large-v3 (32 encoder + 32 decoder layers): B = 16 clips of 1500
# frames (30 s, Whisper's window), a 128-token decoder prompt and 64 new
# tokens (192 positions, under Whisper's 448 decoder targets).
# pixtral-12b (40 layers): B = 2 prompts of 1024 patch embeddings and 7168
# text tokens (8192 positions, as the reference's prefill builder counts
# them, text_len = S - frontend_len), 32 new tokens.  Then a depth cut in
# f32 (2 encoder + 2 decoder layers; 2 layers) through the CUDA-core route.
# The consistency bars are gemma2's (CONSIST_TOL_BF16, CONSIST_TOL_F32):
# both are attention stacks without recurrences or routers.
FRONTEND_ARCHS = ("whisper-large-v3", "pixtral-12b")
FRONTEND_SERVE = {"whisper-large-v3": (16, 128, 64),  # B, text, new tokens
                  "pixtral-12b": (2, 7168, 32)}
FRONTEND_F32_LAYERS = 2
# rows 4e-4g of the kernel table: B, Hq, Hkv, Sq, Sk, D, causal (no window,
# no soft-cap; SDPA computes the same function)
FLASH_FRONTEND = {
    "whisper_encoder": (16, 20, 20, 1500, 1500, 64, False),      # 4e
    "whisper_cross": (16, 20, 20, 128, 1500, 64, False),         # 4f
    "whisper_cross_decode": (16, 20, 20, 1, 1500, 64, False),    # 4f'
    "pixtral": (2, 32, 8, 8192, 8192, 128, True),                # 4g
}
# the dry run's predicted peak over a run's measured one: outside this the
# count is wrong, not the allocator (its rounding to 512-byte blocks, the
# cuBLAS workspace and fragmentation move a peak by a few percent)
DRYRUN_PEAK_RATIO = (0.5, 2.0)
DRYRUN_WORKERS = 4           # processes counting at once (the host has 8 cores)
PLAIN_SCORES_MAX = 4e9       # bytes of f32 scores the plain version takes
#                              whole; past it, a kv head at a time


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
    and at C = 8 and 9 either side of the small-C kernel's cut, beside the
    plain version and 10 ``torch.matmul``s."""
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
    # either side of the small-C kernel's cut (C <= 8: a thread owns its
    # rows; C = 9 takes the warp-per-rows kernel), at LeNet's leaves
    res["small_c_cut"] = {f"C={c}": stage1(c)[0] for c in (8, 9)}
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
    ``flex_attention`` compiled with a soft-cap ``score_mod`` (none at cap
    0), a causal / window block mask and ``enable_gqa``.  A yardstick only:
    the port never calls it."""
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
    mod = softcap if cap else None
    return lambda q, k, v: fn(q, k, v, score_mod=mod, block_mask=mask,
                              enable_gqa=True)


def plain_by_kv_heads(q, k, v, window: int = 0, cap: float = 0.0,
                      causal: bool = True):
    """The plain version one kv head (and its query group) at a time: the
    same function, with (B, G, S, S) f32 scores at a time instead of (B,
    Hq, S, S) (25.8 GB at the MoE layers' 48 heads and 8192 tokens)."""
    import torch
    from repro_torch.kernels import ref
    g = q.shape[1] // k.shape[1]
    return torch.cat([ref.flash_attention_ref(
        q[:, j * g:(j + 1) * g], k[:, j:j + 1], v[:, j:j + 1],
        causal=causal, window=window, softcap=cap)
        for j in range(k.shape[1])], 1)


def bf16_flash_layer(q, k, v, window: int, cap: float, flex,
                     plain=None, causal: bool = True) -> dict:
    """The bf16 flash kernel at one layer's shape (causal, or not): one
    launch on the tensor cores held against the plain version at the layer
    bars, then timed beside the plain version, ``flex`` (the same function
    in one PyTorch call) and the bound.  ``plain`` replaces the plain
    version (``plain_by_kv_heads`` where the whole scores would not fit; it
    is then timed between CUDA events, outside a graph)."""
    import torch
    from repro_torch.kernels import ops, ref
    b, hq, sq, d = q.shape
    sk = k.shape[2]
    chunked = plain is not None
    plain = plain or ref.flash_attention_ref
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              softcap=cap)
    torch.cuda.synchronize()
    assert ops.FLASH_ROUTES == {"tensor_cores": 1, "cuda_cores": 0}
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    want = plain(q, k, v, window=window, cap=cap, causal=causal) \
        if chunked else plain(q, k, v, causal=causal, window=window,
                              softcap=cap)
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=FLASH_LAYER_RTOL_BF16,
                               atol=FLASH_LAYER_ATOL_BF16)
    diff = got.float() - want.float()
    err = float(diff.abs().max())
    rel_rms = float(diff.square().mean().sqrt()
                    / want.float().square().mean().sqrt())
    lib_err = float((flex(q, k, v).float() - want.float()).abs().max())
    del got, want, diff
    pairs = b * hq * flash_pairs(sq, sk, causal, window)
    n_ops = 4 * d * pairs
    n_bytes = 2 * (2 * q.numel() + 2 * k.numel())
    kernel_ms = device_ms(
        lambda: ops.flash_attention(q, k, v, causal=causal, window=window,
                                    softcap=cap),
        reps=2, samples=5)
    bound_ms = max(n_bytes / HBM_BYTES_PER_S, n_ops / BF16_FLOPS) * 1e3
    return {
        "route": "tensor_cores", "max_abs_err": err, "rel_rms_err": rel_rms,
        "ms": kernel_ms,
        "plain_ms": (events_ms(lambda: plain(q, k, v, window=window,
                                              cap=cap, causal=causal),
                               reps=2)
                     if chunked else device_ms(
            lambda: ref.flash_attention_ref(q, k, v, causal=causal,
                                            window=window, softcap=cap),
            reps=1, samples=3)),
        "library_ms": device_ms(lambda: flex(q, k, v), reps=2, samples=5),
        "library_max_abs_err": lib_err,
        "bound_ms": bound_ms,
        "bound_by": ("bytes" if n_bytes / HBM_BYTES_PER_S
                     >= n_ops / BF16_FLOPS else "operations"),
        "share_of_bound": bound_ms / kernel_ms,
        "live_pairs": pairs, "gflop": n_ops / 1e9,
        "tflop_per_s": n_ops / kernel_ms / 1e9,
    }


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
        row = bf16_flash_layer(q, k, v, window, cap, flex)
        n_ops = 4 * d * row["live_pairs"]
        layers[kind] = {
            "window": window, **row,
            "library": "flex_attention (soft-cap score_mod, band block "
                       "mask, enable_gqa; torch.compile)",
            "sdpa_ms": device_ms(
                lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True),
                reps=2, samples=5),
            "sdpa": "a different function: causal, no soft-cap, no window",
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


def check_flash_rg_local(gen) -> dict:
    """The bf16 flash kernel at recurrentgemma-2b's local layer shape (B =
    2, Hq = 10 over Hkv = 1, S = 8192, D = 256, window 2048, no soft-cap),
    as the model hands it over: (B, S, H, D) activations as transposed
    views, the size-1 head dimension included.  Held against the plain
    version at gemma2's layer bars, which imply FLASH_TOL_BF16, and timed
    (``bf16_flash_layer``), ``flex_attention`` with the same mask."""
    import torch
    b, hq, hkv, s, d, window = FLASH_RG_LOCAL
    q, k, v = (torch.randn((b, s, h, d), generator=gen, device=DEV)
               .bfloat16().transpose(1, 2) for h in (hq, hkv, hkv))
    out = {**bf16_flash_layer(q, k, v, window, 0.0,
                              flex_attention_call(s, window, 0.0)),
           "tol": {"rtol": FLASH_LAYER_RTOL_BF16,
                   "atol": FLASH_LAYER_ATOL_BF16},
           "library": "flex_attention (band block mask, enable_gqa; "
                      "torch.compile)",
           "shape": "one recurrentgemma-2b local layer: B=2, Hq=10, Hkv=1, "
                    "S=8192, D=256, window 2048, bf16, no soft-cap"}
    del q, k, v
    gc.collect()
    torch.cuda.empty_cache()
    return out


def check_flash_moe(gen) -> dict:
    """The bf16 flash kernel at grok-1-314b's layer (row 4c: B = 2, Hq =
    48 over Hkv = 8, S = 8192, D = 128, causal) and mixtral-8x22b's (row
    4d: the same with window 4096), from the model's (B, S, H, D) layout,
    held against the plain version (a kv head at a time) at gemma2's layer
    bars and timed (``bf16_flash_layer``).  The library call: for 4c SDPA
    (``is_causal``, ``enable_gqa``: the same function, no soft-cap or
    window), ``flex_attention`` beside it; for 4d ``flex_attention`` with
    the band mask."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    rows = {}
    for arch, (b, hq, hkv, s, d, window) in FLASH_MOE.items():
        q, k, v = (torch.randn((b, s, h, d), generator=gen, device=DEV)
                   .bfloat16().transpose(1, 2) for h in (hq, hkv, hkv))
        flex = flex_attention_call(s, window, 0.0)
        row = bf16_flash_layer(q, k, v, window, 0.0, flex,
                               plain=plain_by_kv_heads)
        row.update(flex_ms=row["library_ms"],
                   tol={"rtol": FLASH_LAYER_RTOL_BF16,
                        "atol": FLASH_LAYER_ATOL_BF16},
                   library="flex_attention (band block mask, enable_gqa; "
                           "torch.compile)",
                   shape=f"one {arch} layer: B={b}, Hq={hq}, Hkv={hkv}, "
                         f"S={s}, D={d}, window {window}, bf16, causal, no "
                         f"soft-cap")
        if not window:
            def sdpa():
                return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                      enable_gqa=True)
            got = ops.flash_attention(q, k, v)
            err = float((sdpa().float() - got.float()).abs().max())
            del got
            row.update(library_ms=device_ms(sdpa, reps=2, samples=5),
                       library="F.scaled_dot_product_attention (is_causal, "
                               "enable_gqa): the same function",
                       library_max_abs_err_vs_kernel=err)
        rows[arch] = row
        del q, k, v
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def check_flash_frontend(gen, shapes=None) -> dict:
    """The bf16 flash kernel at the front-end models' shapes (rows 4e-4g,
    FLASH_FRONTEND): whisper's encoder layer (non-causal, Sq = Sk = 1500,
    which is 23 kv tiles of 64 and 28 keys), its cross-attention in
    prefill (128 queries against 1500 keys) and in decode (1 query: one
    live row in a 128-row tile), and pixtral's layer (causal, group 4, S =
    8192), each from the model's (B, S, H, D) layout, held against the
    plain version (a kv head at a time past PLAIN_SCORES_MAX) at gemma2's
    layer bars and timed (``bf16_flash_layer``) beside SDPA, which
    computes the same function here (no soft-cap, no window).  ``shapes``
    takes other shapes of the same form (FLASH_TPF: a rank's heads)."""
    import torch
    import torch.nn.functional as F
    rows = {}
    for name, (b, hq, hkv, sq, sk, d, causal) in (
            shapes or FLASH_FRONTEND).items():
        q = (torch.randn((b, sq, hq, d), generator=gen, device=DEV)
             .bfloat16().transpose(1, 2))
        k, v = (torch.randn((b, sk, hkv, d), generator=gen, device=DEV)
                .bfloat16().transpose(1, 2) for _ in range(2))

        def sdpa(q, k, v, causal=causal):
            return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                  enable_gqa=True)
        chunked = 4 * b * hq * sq * sk > PLAIN_SCORES_MAX
        row = bf16_flash_layer(q, k, v, 0, 0.0, sdpa, causal=causal,
                               plain=plain_by_kv_heads if chunked else None)
        row.update(tol={"rtol": FLASH_LAYER_RTOL_BF16,
                        "atol": FLASH_LAYER_ATOL_BF16},
                   library=f"F.scaled_dot_product_attention (is_causal="
                           f"{causal}, enable_gqa): the same function",
                   plain="a kv head at a time" if chunked else "whole",
                   shape=f"{name}: B={b}, Hq={hq}, Hkv={hkv}, Sq={sq}, "
                         f"Sk={sk}, D={d}, bf16, "
                         f"{'causal' if causal else 'non-causal'}, no "
                         f"soft-cap")
        rows[name] = row
        del q, k, v
        gc.collect()
        torch.cuda.empty_cache()
    return rows


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


def last_logits_consistency(cfg, params, prompts, with_step=False,
                            front=None, **serve):
    """prefill_last over S + 1 tokens vs prefill over S tokens then one
    decode_step of token S + 1: the last position's logits, (B, V) each.
    ``serve`` passes the MoE ``dispatch`` and ``quantized_cache``; with
    ``with_step`` the decode step's (B, V) f32 logits come back too.
    ``front`` holds a front end's batch input: "enc_out" (the decode step
    attends over it too) or "patch_embeds" (the positions count them)."""
    import torch
    from repro_torch.models import decode_step
    from repro_torch.models.model import prefill_last
    front = front or {}
    s = prompts.shape[1] - 1
    off = front["patch_embeds"].shape[1] if "patch_embeds" in front else 0
    dispatch = serve.get("dispatch", "dense")
    with torch.inference_mode():
        full, _ = prefill_last(cfg, params, {"tokens": prompts, **front},
                               off + s + 1, **serve)
        _, caches = prefill_last(cfg, params,
                                 {"tokens": prompts[:, :s], **front},
                                 off + s + 1, **serve)
        step, _ = decode_step(cfg, params, caches, prompts[:, s:], off + s,
                              enc_out=front.get("enc_out"),
                              dispatch=dispatch)
        del caches
    # the real vocab: the padded entries are -1e30 on both sides
    full = full[:, :cfg.vocab_size].float()
    step = step[:, 0, :cfg.vocab_size].float()
    assert torch.isfinite(full).all() and torch.isfinite(step).all()
    diff = (full - step).abs()
    out = {"max_abs_err": float(diff.max()),
           "rms_err": float(diff.square().mean().sqrt()),
           "logit_rms": float(full.square().mean().sqrt()),
           "argmax_agree": float((full.argmax(-1) == step.argmax(-1))
                                 .float().mean())}
    return (out, step) if with_step else out


def device_kernels(prof):
    """(device ms, name, count) of each kernel in a profile, largest first."""
    import torch
    kernels = [(getattr(e, "self_device_time_total", 0) / 1e3, e.key, e.count)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return sorted(kernels, reverse=True)


def kernel_summary(kernels, wall_ms: float) -> dict:
    """A profile's device time beside the same work's unprofiled wall
    time: busy and idle share, GEMM and flash time, the top kernels."""
    busy = sum(k[0] for k in kernels)
    flash = sum(k[0] for k in kernels if "flash_fwd" in k[1])
    gemm = sum(k[0] for k in kernels if "flash_fwd" not in k[1] and any(
        g in k[1].lower() for g in ("gemm", "xmma", "cutlass", "nvjet")))
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "gemm_ms": gemm, "gemm_share_of_busy": gemm / busy,
            "device_idle_share": 1.0 - busy / wall_ms,
            "flash_attention_ms": flash,
            "flash_attention_share_of_busy": flash / busy,
            "kernel_launches": sum(k[2] for k in kernels),
            "top": [{"name": k[1][:90], "device_ms": k[0], "count": k[2]}
                    for k in kernels[:12]]}


def profile_serving(cfg, params, prompts, prefill_wall_s: float,
                    front=None, **serve) -> dict:
    """Device time by kernel over one full prefill, and over DECODE_STEPS
    decode steps after it, under torch.profiler; each beside the same
    work's unprofiled wall time.  ``serve`` passes the MoE ``dispatch``
    and ``quantized_cache``; ``front`` a front end's batch input, as
    ``last_logits_consistency`` takes it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import decode_step
    from repro_torch.models.model import prefill_last
    front = front or {}
    s = prompts.shape[1]
    off = front["patch_embeds"].shape[1] if "patch_embeds" in front else 0
    batch = {"tokens": prompts, **front}
    max_len = off + s + SERVE_TOKENS
    dispatch = serve.get("dispatch", "dense")
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.inference_mode():
        with profile(activities=acts) as prof:
            prefill_last(cfg, params, batch, max_len, **serve)
            torch.cuda.synchronize()
        pre = device_kernels(prof)
        logits, caches = prefill_last(cfg, params, batch, max_len, **serve)
        tok = logits.argmax(-1)[:, None]

        def steps(first):
            for i in range(first, first + DECODE_STEPS):
                decode_step(cfg, params, caches, tok, off + s + i,
                            enc_out=front.get("enc_out"), dispatch=dispatch)
            torch.cuda.synchronize()
        steps(0)                                  # warm
        t0 = time.perf_counter()
        steps(DECODE_STEPS)
        decode_wall_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=acts) as prof:
            steps(2 * DECODE_STEPS)
        dec = device_kernels(prof)
    return {"phase": "profile_serving", "arch": cfg.name,
            "batch": prompts.shape[0], "prompt": s,
            "prefill": kernel_summary(pre, prefill_wall_s * 1e3),
            "decode_steps": DECODE_STEPS,
            "decode": kernel_summary(dec, decode_wall_ms)}


def decode_at_shape(cfg, params, shape_name: str, gen) -> dict:
    """One decode step of ``cfg`` at a published decode shape through
    ``launch/steps.py::build_decode_step``, on fresh caches from
    ``init_caches`` at the shape's length, at its last position: logits
    finite and of the bundle's shape, then DECODE_SHAPE_STEPS more steps
    timed (host clock, synchronized; median), with the peak memory and the
    caches' bytes."""
    import torch
    from repro_torch.configs import SHAPES, get_profile
    from repro_torch.launch.steps import build_decode_step
    from repro_torch.models import init_caches
    from repro_torch.tree import tree_leaves
    shape = SHAPES[shape_name]
    b, pos = shape.global_batch, shape.seq_len - 1
    bundle = build_decode_step(cfg.name, shape, cfg=cfg)
    assert bundle.meta["dtype"] == cfg.dtype, bundle.meta
    torch.cuda.reset_peak_memory_stats()
    caches = init_caches(cfg, b, shape.seq_len, getattr(torch, cfg.dtype),
                         DEV, quantized=get_profile(cfg.name).kv_int8)
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(caches))
    token = torch.randint(0, cfg.vocab_size, (b, 1), generator=gen,
                          device=DEV)
    times = []
    with torch.inference_mode():
        logits, caches = bundle.fn(params, caches, token, pos)
        torch.cuda.synchronize()
        assert logits.shape == (b, cfg.vocab_padded), logits.shape
        assert torch.isfinite(logits[:, :cfg.vocab_size].float()).all()
        for _ in range(DECODE_SHAPE_STEPS):
            t0 = time.perf_counter()
            bundle.fn(params, caches, token, pos)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(times)
    param_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(params))
    out = {"batch": b, "pos": pos, "ms_per_step": ms, "step_ms": times,
           "tokens_per_s": b / ms * 1e3, "cache_bytes": cache_bytes,
           "param_bytes": param_bytes,
           "read_once_bound_ms": (param_bytes + cache_bytes)
           / HBM_BYTES_PER_S * 1e3,
           "peak_device_mem_mb": torch.cuda.max_memory_allocated() / 1e6}
    del caches, logits
    gc.collect()
    torch.cuda.empty_cache()
    return out


def serve_recurrent_phase(arch: str) -> tuple:
    """A recurrent family at full width and depth in bf16, random weights
    from a seeded generator: ``serve_batch`` twice (B = 2, an 8192-token
    prompt, 32 new tokens; greedy tokens equal; flash launches counted from
    0 around each run: recurrentgemma's 8 local layers on the tensor cores,
    mamba2 none), prefill + decode against a longer prefill (bf16 at full
    depth over 8191 + 1 tokens, f32 over one pattern cycle past the
    window), one decode step at each published decode shape, and one
    prefill and DECODE_STEPS decode steps under torch.profiler.  Returns
    (the phase line, the profile line, the flash launches a prefill)."""
    import torch
    from repro_torch.configs import get_config, replace
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import init_params, param_count
    cfg = get_config(arch)
    gen = torch.Generator(device=DEV).manual_seed(13)
    t0 = time.perf_counter()
    params = init_params(cfg, gen)            # bf16, the config's dtype
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                            generator=gen, device=DEV)
    n_local = sum(k == "local" for k in cfg.layer_kinds())
    runs, launches, routes = [], [], []
    for _ in range(2):
        ops.reset_launches()
        runs.append(serve_batch(cfg, params, prompts, SERVE_TOKENS,
                                device=DEV))
        launches.append(dict(ops.LAUNCHES))
        routes.append(dict(ops.FLASH_ROUTES))
    for count, route in zip(launches, routes):
        # every local layer of the prefill on the tensor cores, once
        assert route == {"tensor_cores": n_local, "cuda_cores": 0}, route
        assert count == {**{key: 0 for key in count},
                         "flash_attention": n_local}, count
    for res in runs:
        assert res.tokens.shape == (SERVE_BATCH, SERVE_TOKENS)
        assert 0 <= int(res.tokens.min()) <= int(res.tokens.max()) \
            < cfg.vocab_size
    assert torch.equal(runs[0].tokens, runs[1].tokens), "greedy decode differs"

    consist = {}
    bf16 = last_logits_consistency(cfg, params, prompts)
    bf16["rms_err_share"] = bf16["rms_err"] / bf16["logit_rms"]
    assert bf16["max_abs_err"] <= CONSIST_REC_MAX_BF16, bf16
    assert bf16["rms_err_share"] <= CONSIST_REC_RMS_BF16, bf16
    consist[f"bf16_{cfg.num_layers}_layers"] = {
        **bf16, "tol": {"max_abs_err": CONSIST_REC_MAX_BF16,
                        "rms_err_share": CONSIST_REC_RMS_BF16},
        "prompt": SERVE_PROMPT - 1}
    decode = {name: decode_at_shape(cfg, params, name, gen)
              for name in RECURRENT_DECODE_SHAPES}
    profile = profile_serving(cfg, params, prompts, runs[1].prefill_s)
    n_params = param_count(params)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    n32 = RECURRENT_F32_LAYERS[arch]
    cfg32 = replace(cfg, num_layers=n32, dtype="float32")
    p32 = init_params(cfg32, gen)
    ops.reset_launches()
    f32 = last_logits_consistency(cfg32, p32,
                                  prompts[:, :RECURRENT_F32_PROMPT + 1])
    f32_routes = dict(ops.FLASH_ROUTES)      # two prefills of n32 layers
    n32_local = sum(k == "local" for k in cfg32.layer_kinds())
    assert f32_routes == {"tensor_cores": 0,
                          "cuda_cores": 2 * n32_local}, f32_routes
    assert f32["max_abs_err"] <= CONSIST_TOL_F32, f32
    consist[f"f32_{n32}_layers"] = {**f32, "tol": CONSIST_TOL_F32,
                                    "prompt": RECURRENT_F32_PROMPT,
                                    "flash_routes": f32_routes}
    del p32, prompts
    gc.collect()
    torch.cuda.empty_cache()
    line = {"phase": "serve_recurrent", "arch": cfg.name,
            "layers": cfg.num_layers, "d_model": cfg.d_model,
            "layer_kinds": {k: cfg.layer_kinds().count(k)
                            for k in cfg.layer_pattern},
            "params": n_params, "dtype": cfg.dtype, "batch": SERVE_BATCH,
            "prompt": SERVE_PROMPT, "new_tokens": SERVE_TOKENS,
            "init_s": init_s, "launches": launches[0],
            "flash_routes": routes[0],
            "runs": [{"prefill_s": r.prefill_s, "decode_s": r.decode_s,
                      "decode_tokens_per_s": r.decode_tokens_per_s,
                      "peak_device_mem_mb": r.peak_device_mem_mb}
                     for r in runs],
            "first_tokens": runs[0].tokens[:, :8].tolist(),
            "consistency": consist, "decode_shapes": decode}
    return line, profile, routes[0]["tensor_cores"]


def serve_moe_phase(arch: str) -> tuple:
    """A mixture of experts at full width, its depth cut to MOE_LAYERS, in
    bf16, random weights from a seeded generator, with its profile's
    dispatch (scan) and KV cache (grok-1 int8): ``serve_batch`` twice (B =
    2, an 8192-token prompt, 32 new tokens; greedy tokens equal; flash
    launches counted from 0 around each run: every layer's prefill on the
    tensor cores), prefill + decode against a longer prefill (bf16 at the
    cut depth over 8191 + 1 tokens, with the profile's cache and, for
    grok-1, with a bf16 cache, the two decode steps held against each
    other; f32 on one layer over MOE_F32_PROMPT + 1 tokens), one prefill
    and DECODE_STEPS decode steps under torch.profiler, and for grok-1 one
    decode step at decode_32k on a MOE_DECODE_LAYERS-layer build.  Returns
    (the phase line, the profile line, the flash launches a prefill)."""
    import torch
    from repro_torch.configs import get_config, get_profile, replace
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import init_caches, init_params, param_count
    from repro_torch.tree import tree_leaves
    full = get_config(arch)
    prof = get_profile(arch)
    serve = dict(dispatch=prof.moe_dispatch, quantized_cache=prof.kv_int8)
    cfg = replace(full, num_layers=MOE_LAYERS[arch])
    gen = torch.Generator(device=DEV).manual_seed(14)
    t0 = time.perf_counter()
    params = init_params(cfg, gen)            # bf16, the config's dtype
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                            generator=gen, device=DEV)
    runs, launches, routes = [], [], []
    for _ in range(2):
        gc.collect()
        torch.cuda.empty_cache()
        ops.reset_launches()
        runs.append(serve_batch(cfg, params, prompts, SERVE_TOKENS,
                                device=DEV, **serve))
        launches.append(dict(ops.LAUNCHES))
        routes.append(dict(ops.FLASH_ROUTES))
    for count, route in zip(launches, routes):
        # every layer's prefill attention on the tensor cores, once
        assert route == {"tensor_cores": cfg.num_layers,
                         "cuda_cores": 0}, route
        assert count == {**{key: 0 for key in count},
                         "flash_attention": cfg.num_layers}, count
    for res in runs:
        assert res.tokens.shape == (SERVE_BATCH, SERVE_TOKENS)
        assert 0 <= int(res.tokens.min()) <= int(res.tokens.max()) \
            < cfg.vocab_size
    assert torch.equal(runs[0].tokens, runs[1].tokens), "greedy decode differs"
    # the same caches in bf16 (meta tensors: shapes only)
    bf16_cache = sum(t.numel() * t.element_size() for t in tree_leaves(
        init_caches(cfg, SERVE_BATCH, SERVE_PROMPT + SERVE_TOKENS,
                    torch.bfloat16, "meta")))

    def held(stats, what):
        stats["rms_err_share"] = stats["rms_err"] / stats["logit_rms"]
        assert stats["max_abs_err"] <= CONSIST_MOE_MAX, (what, stats)
        assert stats["rms_err_share"] <= CONSIST_MOE_RMS, (what, stats)
        return {**stats, "tol": {"max_abs_err": CONSIST_MOE_MAX,
                                 "rms_err_share": CONSIST_MOE_RMS}}
    consist = {}
    cache = "int8" if prof.kv_int8 else "bf16"
    stats, step = last_logits_consistency(cfg, params, prompts,
                                          with_step=True, **serve)
    consist[f"bf16_{cfg.num_layers}_layers_{cache}_cache"] = {
        **held(stats, cache), "prompt": SERVE_PROMPT - 1}
    if prof.kv_int8:
        stats, step16 = last_logits_consistency(
            cfg, params, prompts, with_step=True, dispatch=prof.moe_dispatch)
        consist[f"bf16_{cfg.num_layers}_layers_bf16_cache"] = {
            **held(stats, "bf16 cache"), "prompt": SERVE_PROMPT - 1}
        diff = (step - step16).abs()
        consist["int8_vs_bf16_cache_step"] = held(
            {"max_abs_err": float(diff.max()),
             "rms_err": float(diff.square().mean().sqrt()),
             "logit_rms": float(step16.square().mean().sqrt()),
             "argmax_agree": float((step.argmax(-1) == step16.argmax(-1))
                                   .float().mean())}, "int8 vs bf16")
        del step16
    del step
    profile = profile_serving(cfg, params, prompts, runs[1].prefill_s,
                              **serve)
    # the experts' products (gate, up, down) of a prefill: E / k = 4x the
    # routed FLOP under the scan dispatch
    t = SERVE_BATCH * SERVE_PROMPT
    expert_flop = (cfg.num_layers * cfg.num_experts * 3 * 2 * t
                   * cfg.d_model * cfg.d_ff)
    profile["prefill"]["expert_gemm_flop"] = expert_flop
    profile["prefill"]["expert_gemm_share_of_gemm_flop"] = expert_flop / (
        expert_flop + cfg.num_layers * 2 * t * cfg.d_model
        * (2 * cfg.q_dim + 2 * cfg.kv_dim))
    gemm_ms = profile["prefill"]["gemm_ms"]
    profile["prefill"]["expert_tflop_per_s_if_gemm_ms"] = (
        expert_flop / gemm_ms / 1e9 if gemm_ms else None)
    n_params = param_count(params)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    decode = {}
    if prof.kv_int8:
        cut = replace(full, num_layers=MOE_DECODE_LAYERS)
        p2 = init_params(cut, gen)
        decode["decode_32k"] = {"layers": MOE_DECODE_LAYERS,
                                **decode_at_shape(cut, p2, "decode_32k",
                                                  gen)}
        del p2
        gc.collect()
        torch.cuda.empty_cache()

    cfg32 = replace(full, num_layers=1, dtype="float32")
    p32 = init_params(cfg32, gen)
    ops.reset_launches()
    f32 = last_logits_consistency(cfg32, p32,
                                  prompts[:, :MOE_F32_PROMPT + 1],
                                  dispatch=prof.moe_dispatch)
    f32_routes = dict(ops.FLASH_ROUTES)      # two prefills of one layer
    assert f32_routes == {"tensor_cores": 0, "cuda_cores": 2}, f32_routes
    assert f32["max_abs_err"] <= CONSIST_TOL_F32, f32
    consist["f32_1_layer_f32_cache"] = {**f32, "tol": CONSIST_TOL_F32,
                                        "prompt": MOE_F32_PROMPT,
                                        "flash_routes": f32_routes}
    del p32, prompts
    gc.collect()
    torch.cuda.empty_cache()
    line = {"phase": "serve_moe", "arch": cfg.name,
            "layers": cfg.num_layers, "layers_published": full.num_layers,
            "d_model": cfg.d_model, "d_ff": cfg.d_ff,
            "experts": cfg.num_experts, "top_k": cfg.experts_per_token,
            "params": n_params, "dtype": cfg.dtype,
            "dispatch": prof.moe_dispatch, "kv_cache": cache,
            "batch": SERVE_BATCH, "prompt": SERVE_PROMPT,
            "new_tokens": SERVE_TOKENS, "init_s": init_s,
            "launches": launches[0], "flash_routes": routes[0],
            "cache_bytes": runs[0].cache_bytes,
            "bf16_cache_bytes": bf16_cache,
            "cache_share_of_bf16": runs[0].cache_bytes / bf16_cache,
            "runs": [{"prefill_s": r.prefill_s, "decode_s": r.decode_s,
                      "decode_tokens_per_s": r.decode_tokens_per_s,
                      "peak_device_mem_mb": r.peak_device_mem_mb}
                     for r in runs],
            "first_tokens": runs[0].tokens[:, :8].tolist(),
            "consistency": consist, "decode_shapes": decode,
            "reduced": {"num_layers": f"{full.num_layers} -> "
                                      f"{cfg.num_layers} (bf16 weights of "
                                      f"the full model do not fit one card)",
                        "weights": "random, seeded"}}
    return line, profile, routes[0]["tensor_cores"]


@contextlib.contextmanager
def flash_calls():
    """Count ``ops.flash_attention``'s calls by (Sq, Sk, causal) while the
    block runs (a Counter, yielded), around the real wrapper, whose own
    counts (``LAUNCHES``, ``FLASH_ROUTES``) go on as they do."""
    from repro_torch.kernels import ops
    calls = collections.Counter()
    real = ops.flash_attention

    def counting(q, k, v, **kw):
        calls[(q.shape[2], k.shape[2], kw.get("causal", True))] += 1
        return real(q, k, v, **kw)
    ops.flash_attention = counting
    try:
        yield calls
    finally:
        ops.flash_attention = real


def by_shape(calls) -> dict:
    """A ``flash_calls`` Counter as JSON keys "Sq x Sk, causal"."""
    return {f"{sq}x{sk}, {'causal' if c else 'non-causal'}": n
            for (sq, sk, c), n in sorted(calls.items())}


def serve_frontend_phase(arch: str) -> tuple:
    """A front-end model at full width and depth in bf16, random weights and
    0.1 * normal frames or patch embeddings from a seeded generator
    (FRONTEND_SERVE): ``serve_batch`` twice (greedy tokens equal; flash
    launches counted from 0 around each run, by shape too: whisper's
    encoder layers, its prefill's causal self and cross layers and its
    decode steps' cross layers; pixtral's prefill layers, all on the
    tensor cores), the launches of an encode, a prefill and a decode step
    apart, prefill + decode against a longer prefill (bf16 at full depth,
    f32 on a FRONTEND_F32_LAYERS-layer cut through the CUDA-core route),
    and the encode, one prefill and DECODE_STEPS decode steps under
    torch.profiler.  Returns (the phase line, the profile line, the flash
    launches of one serving run by row of the kernel table)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config, replace
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import decode_step, init_params, param_count
    from repro_torch.models.model import prefill_last
    from repro_torch.models.transformer import encode
    cfg = get_config(arch)
    b, s, new = FRONTEND_SERVE[arch]
    enc_dec = cfg.is_enc_dec
    n, fl = cfg.num_layers, cfg.frontend_len
    gen = torch.Generator(device=DEV).manual_seed(15)
    t0 = time.perf_counter()
    params = init_params(cfg, gen)            # bf16, the config's dtype
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                            device=DEV)
    name = "frames" if enc_dec else "patch_embeds"
    front_in = 0.1 * torch.randn((b, fl, cfg.d_model), generator=gen,
                                 device=DEV)
    # (Sq, Sk, causal) of every flash launch: an encode, a prefill, a step
    if enc_dec:
        stage_calls = {"encode": {(fl, fl, False): cfg.encoder_layers},
                       "prefill": {(s, s, True): n, (s, fl, False): n},
                       "decode_step": {(1, fl, False): n}}
    else:
        stage_calls = {"encode": {}, "prefill": {(fl + s, fl + s, True): n},
                       "decode_step": {}}
    steps = {k: v * (new - 1) for k, v in stage_calls["decode_step"].items()}
    serve_calls = dict(collections.Counter(stage_calls["encode"])
                       + collections.Counter(stage_calls["prefill"])
                       + collections.Counter(steps))
    total = sum(serve_calls.values())
    runs, counts = [], []
    for _ in range(2):
        gc.collect()
        torch.cuda.empty_cache()
        ops.reset_launches()
        with flash_calls() as calls:
            runs.append(serve_batch(cfg, params, prompts, new, device=DEV,
                                    **{name: front_in}))
        counts.append((dict(ops.LAUNCHES), dict(ops.FLASH_ROUTES),
                       dict(calls)))
    for launches, routes, calls in counts:
        assert routes == {"tensor_cores": total, "cuda_cores": 0}, routes
        assert launches == {**{key: 0 for key in launches},
                            "flash_attention": total}, launches
        assert calls == serve_calls, (calls, serve_calls)
    for res in runs:
        assert res.tokens.shape == (b, new)
        assert 0 <= int(res.tokens.min()) <= int(res.tokens.max()) \
            < cfg.vocab_size
        assert (res.encode_s > 0) == enc_dec
    assert torch.equal(runs[0].tokens, runs[1].tokens), "greedy decode differs"

    # the launches of each stage alone, counted from 0 around it
    stages = {}
    with torch.inference_mode(), flash_calls() as calls:
        ops.reset_launches()
        enc_out = (encode(cfg, params, front_in, mode="prefill")
                   if enc_dec else None)
        stages["encode"] = (dict(ops.FLASH_ROUTES), dict(calls))
        front = ({"enc_out": enc_out} if enc_dec
                 else {"patch_embeds": front_in})
        off = 0 if enc_dec else fl
        ops.reset_launches()
        calls.clear()
        logits, caches = prefill_last(cfg, params, {"tokens": prompts,
                                                    **front}, off + s + 1)
        stages["prefill"] = (dict(ops.FLASH_ROUTES), dict(calls))
        ops.reset_launches()
        calls.clear()
        decode_step(cfg, params, caches, logits.argmax(-1)[:, None],
                    off + s, enc_out=enc_out)
        stages["decode_step"] = (dict(ops.FLASH_ROUTES), dict(calls))
        del logits, caches
    for stage, (routes, calls) in stages.items():
        want = stage_calls[stage]
        assert calls == want, (stage, calls, want)
        assert routes == {"tensor_cores": sum(want.values()),
                          "cuda_cores": 0}, (stage, routes)

    consist = {}
    bf16 = last_logits_consistency(cfg, params, prompts, front=front)
    bf16["rms_err_share"] = bf16["rms_err"] / bf16["logit_rms"]
    assert bf16["max_abs_err"] <= CONSIST_TOL_BF16, bf16
    consist[f"bf16_{n}_layers"] = {**bf16, "tol": CONSIST_TOL_BF16,
                                   "prompt": s - 1}
    profile_line = profile_serving(cfg, params, prompts, runs[1].prefill_s,
                                   front=front)
    profile_line["frontend_len"] = fl
    if enc_dec:
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with torch.inference_mode():
            with profile(activities=acts) as prof:
                encode(cfg, params, front_in, mode="prefill")
                torch.cuda.synchronize()
        profile_line["encode"] = kernel_summary(device_kernels(prof),
                                                runs[1].encode_s * 1e3)
    n_params = param_count(params)
    del params, enc_out, front
    gc.collect()
    torch.cuda.empty_cache()

    cut = {"num_layers": FRONTEND_F32_LAYERS, "dtype": "float32"}
    if enc_dec:
        cut["encoder_layers"] = FRONTEND_F32_LAYERS
    cfg32 = replace(cfg, **cut)
    p32 = init_params(cfg32, gen)
    ops.reset_launches()
    with torch.inference_mode():
        front32 = ({"enc_out": encode(cfg32, p32, front_in, mode="prefill")}
                   if enc_dec else {"patch_embeds": front_in})
    f32 = last_logits_consistency(cfg32, p32, prompts, front=front32)
    f32_routes = dict(ops.FLASH_ROUTES)
    # the encode, two prefills and one decode step of the cut
    want32 = (cfg32.encoder_layers + 2 * 2 * cfg32.num_layers
              + cfg32.num_layers if enc_dec else 2 * cfg32.num_layers)
    assert f32_routes == {"tensor_cores": 0, "cuda_cores": want32}, \
        f32_routes
    assert f32["max_abs_err"] <= CONSIST_TOL_F32, f32
    consist[f"f32_{FRONTEND_F32_LAYERS}_layers"] = {
        **f32, "tol": CONSIST_TOL_F32, "prompt": s - 1,
        "encoder_layers": cfg32.encoder_layers, "flash_routes": f32_routes}
    del p32, front32, prompts, front_in
    gc.collect()
    torch.cuda.empty_cache()
    line = {"phase": "serve_frontend", "arch": cfg.name,
            "layers": n, "encoder_layers": cfg.encoder_layers,
            "d_model": cfg.d_model, "heads": [cfg.num_heads,
                                              cfg.num_kv_heads],
            "head_dim": cfg.head_dim, "frontend": cfg.frontend,
            "frontend_len": fl, "params": n_params, "dtype": cfg.dtype,
            "batch": b, "prompt": s, "new_tokens": new, "init_s": init_s,
            "launches": counts[0][0], "flash_routes": counts[0][1],
            "flash_calls": by_shape(counts[0][2]),
            "flash_by_stage": {k: by_shape(v[1]) for k, v in stages.items()},
            "cache_bytes": runs[0].cache_bytes,
            "runs": [{"encode_s": r.encode_s, "prefill_s": r.prefill_s,
                      "decode_s": r.decode_s,
                      "decode_tokens_per_s": r.decode_tokens_per_s,
                      "peak_device_mem_mb": r.peak_device_mem_mb}
                     for r in runs],
            "first_tokens": runs[0].tokens[:, :8].tolist(),
            "consistency": consist,
            "reduced": {"weights": "random, seeded",
                        name: "0.1 * normal, seeded (stubbed front end)"}}
    # the launches of one serving run by row of the kernel table
    got = counts[0][2]
    if enc_dec:
        rows = {"whisper_encoder": got[(fl, fl, False)],
                "whisper_cross": got[(s, fl, False)],
                "whisper_cross_decode": got[(1, fl, False)]}
    else:
        rows = {"pixtral": got[(fl + s, fl + s, True)]}
    return line, profile_line, rows


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


MESH_METHODS = ("fedhc", "fedspace", "fedhc-async")
MESH_LOSS_RTOL, MESH_LOSS_ATOL = 1e-4, 1e-5   # the reference's sharded bar
MESH_RANKS = 2                # ranks sharing the one card (over gloo)
MESH_TIMEOUT_S = 600
# tensor parallelism over "model" (phase tp): qwen2-72b at full width
# (d_model 8192, 64 q / 8 kv heads of 128, d_ff 29,568, vocab 152,064,
# bf16, int8 KV cache as its profile) with its depth cut 80 -> 4 (about
# 11 GB whole; 16 layers until the recurrent pair's phase took the
# script's last seconds, 8 until the MoE training's and slower hosts
# did), served on a (1, 2) mesh of two spawned
# ranks that share the card over gloo: a prefill of B = 2 x 4096 tokens,
# then 16 greedy decode steps, held against the same weights on one rank
# without a mesh: the prefill's last-position logits and, fed the one-rank
# run's tokens, the 16 decode steps' logits at CONSIST_TOL_BF16, the first
# greedy token equal, the decoded tokens that agree counted (each that
# differs printed with the one-rank run's top-2 gap there)
TP_ARCH, TP_LAYERS, TP_MESH = "qwen2-72b", 4, (1, 2)
TP_BATCH, TP_PROMPT, TP_DECODE, TP_SEED = 2, 4096, 16, 7
# gemma2-2b trains one round on a (2, 2) mesh: 2 clients of TP 2, K = 1,
# 2 rows of 4096 tokens a client (2 microbatches), at full width with its
# depth cut 26 -> 6 (four ranks share the card's 80 GB: the dry run
# predicts 26.1 GB a rank at 26 layers, 15.2 GB at 12; 12 until the
# script's time ran short); held against the
# one-device step on the same two-client stack, each leaf within one bf16
# ulp of the leaf's largest magnitude (the one-device update printed in
# the same ulps beside it), the mean client CE at TP_CE_RTOL
TP_TRAIN_ARCH, TP_TRAIN_LAYERS, TP_TRAIN_MESH = "gemma2-2b", 6, (2, 2)
TP_TRAIN_BATCH, TP_TRAIN_SEQ = 4, 4096
# the zero-initialized norm scales are, after one round, lr times a bf16
# gradient: a sum over the 8192 tokens of products that largely cancel,
# which the mesh program rounds in another order (the activation
# gradient arrives as two bf16 partials all-reduced), so they are held at
# the CPU tests' bf16 bar (tests/test_torch_train.py: 2^-5 of the leaf's
# largest magnitude); at smoke size on the CPU they land 2-3 bf16 ulps
# apart
TP_NORM_ATOL_FRAC = 2 ** -5
# the mean client CE of the first round, from the same weights: the two
# forwards differ only in bf16 rounding order, which the serve check sees
# as logit errors of rms 0.018 through 16 layers of qwen2-72b; over the
# 8192 tokens of a client that moves the mean CE by about
# 0.018 / sqrt(8192) = 2e-4, and 1e-3 relative is 0.013 at CE 12.8
TP_CE_RTOL = 1e-3
# the one-device round's update of a weight leaf is 0.03-1.2 bf16 ulps of
# the leaf's largest magnitude, so the one-ulp bar alone would pass a
# wrong gradient; the two rounds' updates (new - start) are held too, by
# their relative L2 difference: a stored weight is the bf16 rounding of
# w - lr g, and a gradient that differs by its rounding order (0.3-0.6%
# relative, as the norm scales show) flips that rounding by one ulp near
# its midpoints: 0.065-0.128 of the update on the H100 (this round, 12
# layers); a gradient off by a factor of 2 gives 1.0, a 3% error ~0.25
TP_UPDATE_RTOL = 0.25
TP_TIMEOUT_S = 900
# row 4h: the bf16 flash kernel at qwen2-72b's heads on one rank of the
# (1, 2) mesh: B, Hq, Hkv, S, D (causal, no window or soft-cap)
FLASH_TP = (TP_BATCH, 32, 4, TP_PROMPT, 128)
# tensor parallelism for the mixtures of experts, the encoder-decoder and
# the vision front end (phase tp_families): each arch at full width, its
# depth cut to fit the phase's time, served on a (1, 2) mesh of two
# spawned ranks sharing the card over gloo and held, as the tp phase
# holds qwen2-72b, against the same weights on one rank without a mesh
# (one process for the three archs one after another, the two ranks
# spawned once for all three): grok-1-314b 64 -> 2 layers (2 x 9.66 GB
# of experts + 1.6 GB of embedding: ~21 GB whole, ~11 GB a rank; int8
# cache, scan dispatch), B = 2 x 4096 tokens; whisper-large-v3 32 + 32
# -> 4 + 4 layers, B = 4 clips of 1500 frames and 128 tokens;
# pixtral-12b 40 -> 4 layers, B = 1 x (1024 patches + 1024 tokens) (4,
# 8 + 8 and 8 layers until the script's time ran short); a
# prefill, then 8 greedy decode steps; grok-1's routing (each layer's
# top-2 experts of every token) compared too
TPF_ARCHS = ("grok-1-314b", "whisper-large-v3", "pixtral-12b")
# every served mesh run (phases tp and tp_families) on TP_MESH: arch ->
# (layers, B, text tokens, decode steps, seed)
TP_SERVES = {TP_ARCH: (TP_LAYERS, TP_BATCH, TP_PROMPT, TP_DECODE, TP_SEED),
             "grok-1-314b": (2, 2, 4096, 8, 11),
             "whisper-large-v3": (4, 4, 128, 8, 11),
             "pixtral-12b": (4, 1, 1024, 8, 11),
             "mamba2-1.3b": (16, 2, 4096, 8, 11),
             "recurrentgemma-2b": (8, 2, 4096, 8, 11)}
# the recurrent pair on the (1, 2) mesh (phase tp_recurrent), at full
# width with the depth cut to the ~40 s the script has left, each
# family's layer pattern kept: mamba2-1.3b 48 -> 16 SSD layers (a rank
# its 32 of 64 heads), recurrentgemma-2b 26 -> 8 (2 cycles of rglru,
# rglru, local and the 2 leftover rglru layers: its rem path and 2 flash
# layers; a rank its 1280 of 2560 RG-LRU channels and 5 of 10 heads)
TPR_ARCHS = ("mamba2-1.3b", "recurrentgemma-2b")
# their held logits (the mesh against one rank): recurrentgemma-2b at
# gemma2's bar; mamba2-1.3b at the recurrent families' bf16 bars
# (CONSIST_REC_*): its bf16 rounding grows with depth, and a mesh rounds
# in other places than one rank (a rank's columns of in_proj in a GEMM of
# another width, the out_proj halves summed), a distance of the size of
# one device's own bf16 error (tests/tp_bf16_rounding.py on the CPU at
# full width, 16 layers, B = 1 x 512: the mesh 0.590 from one device, rms
# 0.123; one device 0.650 from the same weights in float32, rms 0.144)
TPR_BARS = {"mamba2-1.3b": (CONSIST_REC_MAX_BF16, CONSIST_REC_RMS_BF16),
            "recurrentgemma-2b": (CONSIST_TOL_BF16, None)}
# and mamba2-1.3b in float32 (TF32 off, as the port sets it), which tells
# a fault of the mesh program from bf16 rounding: full width, 4 layers, B
# = 1 x 1024 tokens, 4 decode steps fed one rank's tokens, held against
# one rank at TPR_F32_TOL of the logits (the CPU meets 1e-4; a wrong
# block or a missing sum moves the logits by O(1), as the bf16 distances
# 0.4-0.7 show a rounding of that size does)
TPR_F32 = "mamba2-1.3b:float32"
TP_SERVES[TPR_F32] = (4, 1, 1024, 4, 13)
TPR_RUNS = TPR_ARCHS + (TPR_F32,)
TPR_F32_TOL = 1e-3
TPR_BARS[TPR_F32] = (TPR_F32_TOL, None)
# row 4l: the bf16 flash kernel at one recurrentgemma-2b rank's local
# layer on the (1, 2) mesh: B, Hq, Hkv (the kv head gathered whole), S, D,
# window (causal, no soft-cap)
FLASH_TPR = (2, 5, 1, 4096, 256, 2048)
# a token the mesh would route to other experts than one rank (fed one
# rank's routing, so that the two runs' hidden states part by rounding
# alone) must be a router near-tie: one rank's k-th and (k+1)-th router
# logits at most this far apart (8 bf16 ulps at magnitude 1; the logits
# are N(0, 1)-sized, an rms-normalized x against a router of scale
# d^-1/2, and the two runs' residual streams differ by bf16 rounding
# order, ~1e-2 relative)
TPF_ROUTER_TIE = 0.0625
# the bf16 flash kernel at one rank's heads on the (1, 2) mesh: B, Hq,
# Hkv, Sq, Sk, D, causal (grok-1's layer; whisper's encoder layer and its
# cross-attention in decode)
FLASH_TPF = {
    "grok_tp": (2, 24, 4, 4096, 4096, 128, True),
    "whisper_encoder_tp": (4, 10, 10, 1500, 1500, 64, False),
    "whisper_cross_decode_tp": (4, 10, 10, 1, 1500, 64, False),
}


def mesh_scenarios() -> dict:
    """The mesh phase's runs at N = 800, K = 4: fedhc as in
    ``paper_scale`` (10 rounds of 4 minutes, Z = 0.2), fedspace as in
    ``contact`` (10 rounds), fedhc-async as in ``async`` (40 events,
    cohorts of 200, buffers of 50); kernels on."""
    from repro_torch.api import (AsyncSpec, ExecSpec, FleetSpec, Scenario,
                                 TrainSpec)
    on = ExecSpec(use_pallas_kernels=True)
    return {
        "fedhc": Scenario(
            method="fedhc",
            fleet=FleetSpec(num_clients=CONTACT_N, num_clusters=4,
                            round_minutes=4.0, dropout_threshold=0.2),
            train=TrainSpec(rounds=10, eval_every=5), exec=on),
        "fedspace": Scenario(
            method="fedspace",
            fleet=FleetSpec(num_clients=CONTACT_N, num_clusters=4,
                            round_minutes=4.0),
            train=TrainSpec(rounds=10, eval_every=5), exec=on),
        "fedhc-async": Scenario(
            method="fedhc-async",
            fleet=FleetSpec(num_clients=CONTACT_N, num_clusters=4,
                            round_minutes=4.0),
            train=TrainSpec(rounds=ASYNC_EVENTS, eval_every=10,
                            rounds_per_global=5),
            async_=AsyncSpec(cohort=CONTACT_N // 4, buffer=CONTACT_N // 16),
            exec=on)}


def mesh_record(res, launches, reads, steps: int) -> dict:
    """What a mesh run reports: the history, s a round or event, peak MB,
    launches and host reads."""
    return {"history": res.to_history(), "run_s": res.run_s,
            "s_per_step": res.run_s / steps, "setup_s": res.setup_s,
            "peak_device_mem_mb": res.peak_device_mem_mb,
            "mesh_shape": res.mesh_shape, "launches": launches,
            "host_reads": reads}


def mesh_rank(rank: int, world: int, tmp: str) -> None:
    """One rank of the two that share the card (`launch/mesh.spawn_ranks`:
    a gloo process group, NCCL refusing two ranks on one device, over CUDA
    tensors): the client mesh, and each of :func:`mesh_scenarios` through
    ``api.run``; the records go to ``tmp/mesh_rank{rank}.json``."""
    from repro_torch import api
    from repro_torch.core import engine
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib
    mesh = mesh_lib.make_client_mesh(0, device_type="cuda")
    records = {}
    for name, sc in mesh_scenarios().items():
        ops.reset_launches()
        engine.reset_host_reads()
        res = api.run(sc, device="cuda", mesh=mesh)
        records[name] = mesh_record(res, dict(ops.LAUNCHES),
                                    dict(engine.HOST_READS),
                                    sc.train.rounds)
    with open(Path(tmp) / f"mesh_rank{rank}.json", "w") as f:
        json.dump(records, f)


def hold_sharded(a: dict, b: dict, what: str) -> None:
    """The reference's sharded bar between two history dicts:
    re-clusters, stage-2 rounds, flushes and eval rounds exact, time and
    energy rtol 1e-5, loss rtol 1e-4 atol 1e-5, accuracy atol 5e-3."""
    import numpy as np
    for key in ("round", "reclusters", "global_rounds", "flushes"):
        assert a.get(key) == b.get(key), (what, key, a.get(key), b.get(key))
    for key in ("time_s", "energy_j"):
        x, y = np.asarray(a[key], float), np.asarray(b[key], float)
        assert np.all(np.abs(x - y) <= TRAJ_RTOL * np.abs(y)), (what, key,
                                                                 x, y)
    x, y = np.asarray(a["loss"], float), np.asarray(b["loss"], float)
    assert np.all(np.abs(x - y) <= MESH_LOSS_ATOL + MESH_LOSS_RTOL
                  * np.abs(y)), (what, "loss", x, y)
    x, y = np.asarray(a["acc"], float), np.asarray(b["acc"], float)
    assert np.all(np.abs(x - y) <= ACC_ATOL), (what, "acc", x, y)


def mesh_phase(tmp: Path) -> dict:
    """The client mesh at N = 800 (`launch/mesh.py`,
    `core/aggregation_spmd.py`).  W = 1 under NCCL in this process: fedhc
    equal with ``==`` to the unsharded run, host reads and launches
    equal.  Then two spawned ranks on the one card over gloo: fedhc,
    fedspace and fedhc-async, each held to its single-device run at the
    sharded bar, the kernels launched on that path (each rank one stage-1
    launch a round or event on its C/2 rows, one drift check a round);
    per rank s a round or event, peak MB and the bytes all-reduced by a
    stage-1.  A failing rank fails the phase."""
    import torch
    import torch.distributed as dist
    from repro_torch import api
    from repro_torch.core import engine
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib

    tmp = tmp.resolve()          # a file:// store needs an absolute path
    scs = mesh_scenarios()
    single = {}
    for name, sc in scs.items():
        ops.reset_launches()
        engine.reset_host_reads()
        res = api.run(sc, device=DEV)
        single[name] = mesh_record(res, dict(ops.LAUNCHES),
                                   dict(engine.HOST_READS), sc.train.rounds)
    gc.collect()
    torch.cuda.empty_cache()

    # ---- W = 1 under NCCL: the unsharded run, bit for bit ---------------
    store = tmp / "mesh_nccl.store"
    store.unlink(missing_ok=True)
    mesh_lib.init_process_group("cuda", init_method=f"file://{store}",
                                rank=0, world_size=1)
    turns = {"single": [], "w1": []}
    try:
        assert dist.get_backend() == "nccl", dist.get_backend()
        mesh = mesh_lib.make_client_mesh(0, device_type="cuda")
        # NCCL builds its communicator at the first collective: once,
        # outside the timed runs
        dist.all_reduce(torch.zeros(1, device=DEV))
        cache = {}
        for which in ("single", "w1", "w1", "single"):
            ops.reset_launches()
            engine.reset_host_reads()
            res = api.run(scs["fedhc"], device=DEV,
                          mesh=mesh if which == "w1" else None,
                          setup_cache=cache)
            turns[which].append(mesh_record(
                res, dict(ops.LAUNCHES), dict(engine.HOST_READS), 10))
        del cache
    finally:
        dist.destroy_process_group()
    want = single["fedhc"]
    for rec in turns["w1"] + turns["single"]:
        assert rec["history"] == want["history"], (rec["history"],
                                                    want["history"])
        assert rec["launches"] == want["launches"], rec["launches"]
        assert rec["host_reads"] == want["host_reads"], rec["host_reads"]
    assert all(r["mesh_shape"] == {"clients": 1} for r in turns["w1"])
    w1 = turns["w1"][0]
    gc.collect()
    torch.cuda.empty_cache()

    # ---- two ranks on the one card over gloo ---------------------------
    outs = [tmp / f"mesh_rank{r}.json" for r in range(MESH_RANKS)]
    for path in outs:
        path.unlink(missing_ok=True)
    t0 = time.perf_counter()
    mesh_lib.spawn_ranks(mesh_rank, MESH_RANKS, (str(tmp),),
                         device_type="cuda", timeout_s=MESH_TIMEOUT_S)
    wall_s = time.perf_counter() - t0
    ranks = [json.loads(path.read_text()) for path in outs]

    k, p_total = 4, sum(lenet_leaf_sizes())
    for name, sc in scs.items():
        steps = sc.train.rounds
        for r, rec in enumerate(ranks):
            got = rec[name]
            assert got["mesh_shape"] == {"clients": MESH_RANKS}, got
            assert got["history"] == ranks[0][name]["history"], (name, r)
            assert got["host_reads"] == single[name]["host_reads"], (
                name, r, got["host_reads"], single[name]["host_reads"])
            hold_sharded(got["history"], single[name]["history"],
                         f"{name} rank {r} vs single")
            launches = got["launches"]
            if name == "fedhc-async":
                assert launches["weighted_agg_multi"] == steps, launches
                assert launches["kmeans_assign"] == 0, launches
            else:
                recl = got["history"]["reclusters"]
                assert launches["weighted_agg_multi"] == steps + recl, \
                    launches
                assert launches["kmeans_assign"] == steps, launches
            # a stage-1 all-reduces the (K, P) f32 partials once
            got["stage1_allreduce_bytes"] = k * p_total * 4
    return {"phase": "mesh", "num_clients": CONTACT_N, "num_clusters": 4,
            "w1_nccl": {"equal": True,
                        "run_s": [r["run_s"] for r in turns["w1"]],
                        "single_run_s": [r["run_s"]
                                         for r in turns["single"]],
                        "order": "single, w1, w1, single (one setup each)",
                        "peak_device_mem_mb": w1["peak_device_mem_mb"],
                        "launches": w1["launches"],
                        "host_reads": w1["host_reads"]},
            # a sync round gathers (C, 4) f32 (losses, participation,
            # member time and energy); an async event (C, 6) plus the
            # (C,) clocks of a partial cohort
            "gather_bytes": {"sync_round": CONTACT_N * 4 * 4,
                             "async_event": CONTACT_N * 7 * 4},
            "single": {name: {key: rec[key] for key in (
                "s_per_step", "setup_s", "peak_device_mem_mb", "launches",
                "host_reads")} for name, rec in single.items()},
            "ranks": [{name: {key: rec[key] for key in (
                "s_per_step", "setup_s", "peak_device_mem_mb", "launches",
                "host_reads", "stage1_allreduce_bytes")}
                for name, rec in r.items()} for r in ranks],
            "histories": {name: {"single": single[name]["history"],
                                 "mesh": ranks[0][name]["history"]}
                          for name in scs},
            "ranks_wall_s": wall_s, "backend": "gloo over CUDA tensors"}


def tp_config(arch: str, layers: int):
    """The config (depth cut, the profile's dtype) and profile of a tp
    run."""
    from repro_torch.configs import get_config, get_profile, replace
    prof = get_profile(arch)
    return replace(get_config(arch), num_layers=layers,
                   dtype=prof.param_dtype), prof


def tp_out(tmp: str, tag: str, rank: int) -> Path:
    """Where rank ``rank`` of the spawned ranks ``tag`` writes its
    record (its tensors beside it, under the same name + ``.pt``)."""
    return Path(tmp) / f"{tag}_rank{rank}.json"


def tp_one_train(rank: int, world: int, tmp: str, tag: str,
                 want: str) -> None:
    """The gemma2-2b round on one device: the one-device step over the
    two-client stack (every client the model TP_SEED draws), the kernels
    on; each client's new tree to ``want + ".{c}.pt"``, the record to
    :func:`tp_out`."""
    import torch
    from repro_torch.core import aggregation
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_lib
    from repro_torch.tree import tree_map
    cfg, prof = tp_config(TP_TRAIN_ARCH, TP_TRAIN_LAYERS)
    bundle = tp_train_bundle(cfg, prof, None)
    stack = aggregation.broadcast_global(
        train_lib.init_model(cfg, TP_SEED, DEV), 2)
    batch = tp_train_batch()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    stack, loss = bundle.fn(stack, batch, 0)
    torch.cuda.synchronize()
    rec = {"s": time.perf_counter() - t0, "loss": float(loss),
           "peak_device_mem_mb": torch.cuda.max_memory_allocated() / 1e6,
           "launches": dict(ops.LAUNCHES)}
    for c in range(2):
        torch.save(tree_map(lambda x: x[c].cpu(), stack), f"{want}.{c}.pt")
    tp_out(tmp, tag, rank).write_text(json.dumps(rec))


def tp_serve_record(res, launches, traffic, steps: int) -> dict:
    return {"tokens": res.tokens.tolist(), "prefill_s": res.prefill_s,
            "encode_s": res.encode_s, "decode_s": res.decode_s,
            "decode_s_per_step": res.decode_s / steps,
            "decode_tokens_per_s": res.decode_tokens_per_s,
            "peak_device_mem_mb": res.peak_device_mem_mb,
            "cache_bytes": res.cache_bytes, "launches": launches,
            "serve_bytes_by_axis": traffic}


def tp_train_rank(rank: int, world: int, tmp: str, tag: str,
                  want: str) -> None:
    """One rank of the gemma2-2b (2, 2) round: its client's blocks of the
    one model every client starts from (TP_SEED;
    `launch/mesh.local_blocks`), its client's rows of the round's batch,
    one round of the mesh form of the train step (collectives timed),
    then its new blocks against its client's row of the one-device round
    (``want``, a saved tree a client), each leaf in bf16 ulps of the
    leaf's largest magnitude: the distance between the two, the
    one-device round's update (new - start) beside it, and the distance
    over the update's norm (the two updates' relative difference)."""
    import torch
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps
    from repro_torch.launch import train as train_lib
    from repro_torch.sharding import parallel as P
    from repro_torch.sharding import rules
    from repro_torch.tree import tree_leaves, tree_map
    mesh = mesh_lib.make_mesh(TP_TRAIN_MESH, device_type="cuda")
    cfg, prof = tp_config(TP_TRAIN_ARCH, TP_TRAIN_LAYERS)
    bundle = tp_train_bundle(cfg, prof, mesh)
    specs = steps.param_specs(cfg, prof, mesh)
    local, _ = mesh_lib.local_blocks(
        lambda: train_lib.init_model(cfg, TP_SEED, DEV), specs, mesh)
    start = [x.cpu() for x in tree_leaves(local)]
    stack = tree_map(lambda x: x[None], local)
    del local
    client = mesh.get_local_rank("data")
    batch = {k: v[client:client + 1] for k, v in tp_train_batch().items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    P.reset_traffic()
    t0 = time.perf_counter()
    with P.timed() as secs:
        stack, loss = bundle.fn(stack, batch, 0)
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        coll = dict(secs)
    peak = torch.cuda.max_memory_allocated() / 1e6
    rec = {"rank": rank, "client": client, "s": s, "loss": float(loss),
           "collective_s": coll, "gloo_share": sum(coll.values()) / s,
           "bytes_by_axis": P.traffic(), "peak_device_mem_mb": peak,
           "rank_accum": bundle.meta["rank_accum"]}
    ref = torch.load(f"{want}.{client}.pt", mmap=True)
    ref = rules.local_shard(ref, specs, mesh)
    ulps, update_ulps, update_rel, finite = {}, {}, {}, True
    for (path, got), w, w0 in zip(leaf_paths(stack), tree_leaves(ref),
                                  start):
        g, w, w0 = got[0].float(), w.to(DEV).float(), w0.to(DEV).float()
        finite = finite and bool(torch.isfinite(g).all())
        scale = torch.maximum(g.abs().max(), w.abs().max())
        ulp = float(bf16_ulp(scale.reshape(1))[0])
        gap = float((g - w).abs().max())
        ulps[path] = gap / ulp
        w0 = w - w0                              # the one-device update
        update_ulps[path] = float(w0.abs().max()) / ulp
        update_rel[path] = float((g - w).norm() / w0.norm())
        if path.endswith("/scale"):
            assert gap <= TP_NORM_ATOL_FRAC * float(scale), (path,
                                                             ulps[path])
        del g, w, w0
    weights = [k for k in ulps if not k.endswith("/scale")]
    norms = [k for k in ulps if k.endswith("/scale")]
    rec.update(max_ulps_of_leaf_scale=max(ulps[k] for k in weights),
               norm_scales_max_ulps=max(ulps[k] for k in norms),
               min_update_ulps=min(update_ulps[k] for k in weights),
               max_update_rel_err=max(update_rel[k] for k in weights),
               finite=finite, ulps_by_leaf=ulps,
               update_ulps_by_leaf=update_ulps,
               update_rel_err_by_leaf=update_rel)
    tp_out(tmp, tag, rank).write_text(json.dumps(rec))


def leaf_paths(tree, prefix=""):
    """(path, leaf) of each leaf of a tree of dicts and tuples, in leaf
    order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in leaf_paths(v, f"{prefix}/{k}")]
    if isinstance(tree, tuple):
        return [x for i, v in enumerate(tree)
                for x in leaf_paths(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def tp_train_bundle(cfg, prof, mesh):
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch import steps
    shape = InputShape("tp_train", TP_TRAIN_SEQ, TP_TRAIN_BATCH, "train")
    kw = dict(num_clusters=1, lr=0.01, rounds_per_global=2, cfg=cfg,
              profile=prof)
    if mesh is None:
        kw.update(num_clients=2, use_kernels=True)
    return steps.build_train_step(TP_TRAIN_ARCH, shape, mesh, **kw)


def tp_train_batch() -> dict:
    """The round's (2, 2, 4096) batch, as ``launch/train.py`` draws it."""
    import torch
    from repro_torch.data.synthetic import synthetic_lm_batches
    gen = torch.Generator(device=DEV).manual_seed(TP_SEED + 1)
    t = synthetic_lm_batches(gen, 2, TP_TRAIN_SEQ, TP_TRAIN_BATCH // 2)
    return {"tokens": t[..., :-1], "labels": t[..., 1:]}


def tp_spawn(target, world: int, tmp: Path, tag: str, *extra) -> list:
    """``world`` ranks of ``target`` spawned by `launch/mesh.spawn_ranks`
    (ranks that share the card run gloo), with expandable allocator
    segments (four ranks share the card: no segment left half used);
    each rank's record back.  A failing rank fails the phase."""
    import os
    from repro_torch.launch import mesh as mesh_lib
    outs = [tp_out(tmp, tag, r) for r in range(world)]
    for path in outs:
        path.unlink(missing_ok=True)
    key = "PYTORCH_CUDA_ALLOC_CONF"
    old = os.environ.get(key)
    os.environ[key] = "expandable_segments:True"     # the ranks inherit it
    try:
        mesh_lib.spawn_ranks(target, world, (str(tmp), tag) + extra,
                             device_type="cuda", timeout_s=TP_TIMEOUT_S)
    finally:
        if old is None:
            os.environ.pop(key)
        else:
            os.environ[key] = old
    return [json.loads(path.read_text()) for path in outs]


def check_flash_tp(gen) -> dict:
    """Row 4h: the bf16 flash kernel at one qwen2-72b rank's heads on the
    (1, 2) mesh (B = 2, Hq = 32 over Hkv = 4, S = 4096, D = 128, causal),
    held against the plain version (a kv head at a time) at gemma2's
    layer bars and timed beside SDPA (``is_causal``, ``enable_gqa``: the
    same function)."""
    import torch
    import torch.nn.functional as F
    b, hq, hkv, s, d = FLASH_TP
    q, k, v = (torch.randn((b, s, h, d), generator=gen, device=DEV)
               .bfloat16().transpose(1, 2) for h in (hq, hkv, hkv))

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              enable_gqa=True)
    row = bf16_flash_layer(q, k, v, 0, 0.0, sdpa, plain=plain_by_kv_heads)
    row.update(tol={"rtol": FLASH_LAYER_RTOL_BF16,
                    "atol": FLASH_LAYER_ATOL_BF16},
               library="F.scaled_dot_product_attention (is_causal, "
                       "enable_gqa): the same function",
               shape=f"one qwen2-72b layer on one rank of a (1, 2) mesh: "
                     f"B={b}, Hq={hq}, Hkv={hkv}, S={s}, D={d}, bf16, "
                     f"causal, no soft-cap")
    del q, k, v
    gc.collect()
    torch.cuda.empty_cache()
    return row


def hold_serve(cfg, want, got, one_rec: dict, ranks: list,
               bars=(CONSIST_TOL_BF16, None)) -> dict:
    """A mesh serve held against one rank's: ``want`` and ``got`` (B, 1 +
    decode steps, V) f32 logits (the prefill's last position, then each
    decode step fed the one-rank run's tokens; ``got`` the ranks' vocab
    slices concatenated), within ``bars`` at every step (the largest
    distance, and where given the rms distance over the logits' rms;
    CONSIST_TOL_BF16 by default); every
    rank's greedy tokens alike, the first equal to one rank's; each token
    that differs listed with the one-rank run's top-2 gap there, and
    where a row first parts that gap within twice the logits' distance
    (the same history: only a near-tie can part them)."""
    import torch
    assert got.shape == want.shape, (got.shape, want.shape)
    got, want = got[..., :cfg.vocab_size], want[..., :cfg.vocab_size]
    assert torch.isfinite(got).all()
    diff = (got - want).abs()
    step_err = diff.amax(dim=(0, 2))
    logits = {"max_abs_err": float(step_err[0]),
              "rms_err": float(diff[:, 0].square().mean().sqrt()),
              "logit_rms": float(want[:, 0].square().mean().sqrt()),
              "argmax_agree": float((got[:, 0].argmax(-1)
                                     == want[:, 0].argmax(-1))
                                    .float().mean()),
              "tol": bars[0], "rms_share_tol": bars[1]}
    decode = {"max_abs_err": float(step_err[1:].max()),
              "max_abs_err_by_step": step_err[1:].tolist(),
              "rms_err": float(diff[:, 1:].square().mean().sqrt()),
              "logit_rms": float(want[:, 1:].square().mean().sqrt()),
              "argmax_agree": float((got[:, 1:].argmax(-1)
                                     == want[:, 1:].argmax(-1))
                                    .float().mean()),
              "tol": bars[0], "rms_share_tol": bars[1]}
    for held in (logits, decode):
        held["rms_err_share"] = held["rms_err"] / held["logit_rms"]
        assert held["max_abs_err"] <= bars[0], held
        assert bars[1] is None or held["rms_err_share"] <= bars[1], held
    toks = torch.tensor(one_rec["tokens"])
    for r in ranks:
        assert r["tokens"] == ranks[0]["tokens"], "ranks disagree"
    mesh_toks = torch.tensor(ranks[0]["tokens"])
    assert torch.equal(mesh_toks[:, 0], toks[:, 0]), (mesh_toks, toks)
    agree = (mesh_toks == toks)
    first_off = [int(row.logical_not().nonzero()[0]) if not row.all()
                 else toks.shape[1] for row in agree]
    # the one-rank run's top-2 gap at each token it picked (its logits
    # row i gives token i), and the mesh's margin between the two picks
    # (the same history where the token is its row's first difference)
    top2 = want.topk(2, dim=-1).values
    gaps = top2[..., 0] - top2[..., 1]
    differs = [{"row": b, "token": i, "first_in_row": i == first_off[b],
                "one_rank_top2_gap": float(gaps[b, i]),
                "mesh_margin": float(got[b, i, mesh_toks[b, i]]
                                     - got[b, i, toks[b, i]])}
               for b, i in agree.logical_not().nonzero().tolist()]
    replay = int((want.argmax(-1) == toks).sum())
    for d in differs:
        if d["first_in_row"]:
            assert d["one_rank_top2_gap"] <= 2 * decode["max_abs_err"], d
    return {"logits_vs_one_rank": logits,
            "decode_logits_vs_one_rank": decode,
            "first_token_equal": True,
            "decoded_tokens_agree": int(agree.sum()),
            "decoded_tokens": agree.numel(),
            "first_disagreement_at": first_off,
            "tokens_that_differ": differs,
            "one_rank_replay_agrees": replay}


def hold_routing(cfg, one: list, ranks: list) -> dict:
    """A MoE serve's routing on the mesh against one rank's: ``one`` and
    each rank's ``ranks[r]`` hold, a step (the prefill, then each decode
    step), a layer's (sorted top-k experts (B, S, k), log probabilities
    (B, S, E)), the mesh's the experts it would have picked itself.  The
    ranks route alike (the first rank's indices,
    `parallel.agree_over_model`).  The mesh run was fed one rank's
    routing, so its hidden states follow one rank's within rounding at
    every layer and position: every token a layer it would have routed
    otherwise must be a near-tie, one rank's gap between its k-th and
    (k+1)-th router logits at most TPF_ROUTER_TIE.  Returns the routings
    (a token a layer) and those apart, by step, the largest gap and
    router-log-probability distance among them, and the first 16."""
    import torch
    k = cfg.experts_per_token
    mesh = ranks[0]
    for r in ranks[1:]:
        assert all(torch.equal(a[0], b[0]) for sa, sb in zip(r, mesh)
                   for a, b in zip(sa, sb)), "the ranks routed apart"
    assert len(one) == len(mesh)
    apart, tokens, by_step = [], 0, []
    for i, (s_one, s_mesh) in enumerate(zip(one, mesh)):
        assert len(s_one) == len(s_mesh) == cfg.num_layers
        n = 0
        for lay, ((ia, la), (ib, lb)) in enumerate(zip(s_mesh, s_one)):
            off = (ia != ib).any(-1)                      # (B, S)
            tokens += off.numel()
            n += int(off.sum())
            for b, t in off.nonzero().tolist():
                top = lb[b, t].sort(descending=True).values
                apart.append({"step": i, "layer": lay, "row": b,
                              "token": t,
                              "one_rank_gap": float(top[k - 1] - top[k]),
                              "router_distance": float(
                                  (la[b, t] - lb[b, t]).abs().max())})
                assert apart[-1]["one_rank_gap"] <= TPF_ROUTER_TIE, \
                    apart[-1]
        by_step.append(n)
    return {"routings": tokens, "routed_apart": len(apart),
            "share_whose_topk_differ": len(apart) / tokens,
            "apart_by_step": by_step,
            "max_one_rank_gap": max((a["one_rank_gap"] for a in apart),
                                    default=None),
            "max_router_distance": max((a["router_distance"]
                                        for a in apart), default=None),
            "tie_bar": TPF_ROUTER_TIE, "first_apart": apart[:16]}


def tp_phase(smi: str, tmp: Path, gen) -> tuple:
    """Tensor parallelism over "model" and FSDP over "data" on the card
    (`sharding/parallel.py`): qwen2-72b served on a (1, 2) mesh and
    gemma2-2b trained one round on a (2, 2) mesh, each against the same
    weights on one rank without a mesh, the ranks spawned processes
    sharing the card over gloo; then row 4h (flash at qwen2-72b's heads
    on one rank).  The serve is held by the prefill's last-position
    logits and, fed the one-rank run's greedy tokens, every decode
    step's (the int8 cache's writes on the rank that owns a slot, the
    log-sum-exp merge over "model"), and by its own greedy tokens, each
    that differs printed with the one-rank run's top-2 gap there.
    Returns the phase line, row 4h and the flash launches a tp rank made
    on the serve path."""
    import torch
    tmp = tmp.resolve()
    t_phase = time.perf_counter()

    # ---- qwen2-72b, one rank, no mesh: the same weights and prompts (a
    # spawned process, so that its memory goes with it) ------------------
    cfg, prof = tp_serve_config(TP_ARCH)
    one_rec = tp_spawn(tp_serve_rank, 1, tmp, "tp_one",
                       (TP_ARCH,))[0][TP_ARCH]

    # ---- qwen2-72b on the (1, 2) mesh -------------------------------------
    world = TP_MESH[0] * TP_MESH[1]
    t0 = time.perf_counter()
    ranks = [r[TP_ARCH] for r in tp_spawn(tp_serve_rank, world, tmp,
                                          "tp_serve", (TP_ARCH,),
                                          "tp_one")]
    serve_wall = time.perf_counter() - t0
    # (B, 1 + TP_DECODE, V): the prefill's last position, then each
    # decode step fed the one-rank run's tokens
    want = torch.load(f"{tp_out(tmp, f'tp_one_{TP_ARCH}', 0)}.pt")["logits"]
    got = torch.cat([torch.load(
        f"{tp_out(tmp, f'tp_serve_{TP_ARCH}', r)}.pt")["logits"]
        for r in range(world)], -1)
    for r in ranks:
        assert r["launches"]["flash_attention"] == TP_LAYERS, r["launches"]
    held = hold_serve(cfg, want, got, one_rec, ranks)
    logits, decode = held["logits_vs_one_rank"], \
        held["decode_logits_vs_one_rank"]
    assert one_rec["launches"]["flash_attention"] == TP_LAYERS

    # ---- gemma2-2b, one round: the one-device step on the two-client
    # stack, then the (2, 2) mesh ------------------------------------------
    want_path = tmp / "tp_train_one"
    one_train = tp_spawn(tp_one_train, 1, tmp, "tp_train_one_run",
                         str(want_path))[0]
    twin = TP_TRAIN_MESH[0] * TP_TRAIN_MESH[1]
    t0 = time.perf_counter()
    trank = tp_spawn(tp_train_rank, twin, tmp, "tp_train", str(want_path))
    train_wall = time.perf_counter() - t0
    for r in trank:
        assert r["finite"], r
        assert abs(r["loss"] - one_train["loss"]) <= TP_CE_RTOL * abs(
            one_train["loss"]), (r["loss"], one_train["loss"])
        assert r["max_ulps_of_leaf_scale"] <= TRAIN_STACK_ULPS, r
        assert r["max_update_rel_err"] <= TP_UPDATE_RTOL, r
    for c in range(2):
        want_path.with_name(f"tp_train_one.{c}.pt").unlink()

    flash = check_flash_tp(gen)
    line = {
        "phase": "tp", "nvidia_smi": smi,
        "backend": "gloo over CUDA tensors (ranks share the card)",
        "serve": {"arch": TP_ARCH, "layers": TP_LAYERS,
                  "reduced": f"depth 80 -> {TP_LAYERS}",
                  "mesh": {"data": TP_MESH[0], "model": TP_MESH[1]},
                  "batch": TP_BATCH, "prompt": TP_PROMPT,
                  "decode_steps": TP_DECODE, "kv_int8": prof.kv_int8,
                  **held, "one_rank": one_rec, "ranks": ranks,
                  "ranks_wall_s": serve_wall},
        "train": {"arch": TP_TRAIN_ARCH, "layers": TP_TRAIN_LAYERS,
                  "reduced": f"depth 26 -> {TP_TRAIN_LAYERS}",
                  "mesh": {"data": TP_TRAIN_MESH[0],
                           "model": TP_TRAIN_MESH[1]},
                  "clients": 2, "clusters": 1, "seq": TP_TRAIN_SEQ,
                  "global_batch": TP_TRAIN_BATCH,
                  "stack_ulps_bar": {
                      "weights": f"{TRAIN_STACK_ULPS} bf16 ulp of the "
                                 f"leaf's largest magnitude",
                      "norm_scales": f"{TP_NORM_ATOL_FRAC} of the leaf's "
                                     f"largest magnitude",
                      "updates": f"{TP_UPDATE_RTOL} relative (L2) between "
                                 f"the two rounds' new - start"},
                  "ce_rtol": TP_CE_RTOL, "one_device": one_train,
                  "ranks": trank, "ranks_wall_s": train_wall},
        "flash_tp": flash, "phase_s": time.perf_counter() - t_phase}
    return line, flash, ranks[0]["launches"]["flash_attention"]


def tp_serve_config(key: str):
    """The config (depth cut, an encoder-decoder's encoder too; the
    profile's dtype, or the dtype after the key's ":") and profile of a
    served mesh run (TP_SERVES)."""
    from repro_torch.configs import (depth_cut, get_config, get_profile,
                                     replace)
    arch, _, dtype = key.partition(":")
    prof = get_profile(arch)
    return replace(depth_cut(get_config(arch), TP_SERVES[key][0]),
                   dtype=dtype or prof.param_dtype), prof


def tp_serve_reduced(arch: str) -> str:
    """The depth cut of a served mesh run, as PERF.md's ``reduced``."""
    from repro_torch.configs import get_config
    full = get_config(arch.partition(":")[0])
    cut = tp_serve_config(arch)[0]
    if full.encoder_layers:
        return (f"depth {full.encoder_layers} + {full.num_layers} -> "
                f"{cut.encoder_layers} + {cut.num_layers}")
    return f"depth {full.num_layers} -> {cut.num_layers}"


def tp_serve_cache(arch: str) -> int:
    """The cache slots ``serve_batch`` sizes on the mesh: a vision
    prompt's patches, the text and the new tokens, rounded up to whole
    blocks of slots a rank."""
    from repro_torch.configs import get_config
    cfg = get_config(arch.partition(":")[0])
    _, _, text, n_dec, _ = TP_SERVES[arch]
    patches = cfg.frontend_len if cfg.frontend == "vision" else 0
    n = patches + text + n_dec + 1
    return -(-n // TP_MESH[1]) * TP_MESH[1]


def tp_serve_rank(rank: int, world: int, tmp: str, tag: str, archs: tuple,
                  one: "str | None" = None) -> None:
    """One process of a served mesh run (TP_SERVES), ``archs`` one after
    another: without ``one`` the one-rank run (the whole model, no mesh),
    else a rank of the TP_MESH mesh (its blocks of the same model,
    `launch/mesh.local_blocks`), ``one`` the one-rank run's tag.  Each
    arch's weights, prompts and front-end input drawn from its seed,
    ``serve_batch`` with the counts set to 0 just before it (launches,
    flash calls by shape, the collectives' bytes), then
    :func:`tp_serve_steps` fed the one-rank run's greedy tokens (its own,
    or the run ``one``'s) and, on the mesh, a MoE arch the one-rank run's
    routing.  Writes {arch: record} to :func:`tp_out`."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import init_params
    from repro_torch.sharding import parallel as P
    from repro_torch.tree import tree_leaves
    mesh = (None if one is None
            else mesh_lib.make_mesh(TP_MESH, device_type="cuda"))
    recs = {}
    for arch in archs:
        t0 = time.perf_counter()
        cfg, prof = tp_serve_config(arch)
        _, b, text, n_dec, seed = TP_SERVES[arch]
        assert cfg.dtype != "float32" or not (
            torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32), "TF32 is on"
        gen = torch.Generator(device=DEV).manual_seed(seed)
        tp = None if mesh is None else steps.mesh_program(mesh, prof)
        if mesh is None:
            params = init_params(cfg, gen)
        else:
            params, _ = mesh_lib.local_blocks(
                lambda: init_params(cfg, gen),
                steps.param_specs(cfg, prof, mesh), mesh)
        prompts = torch.randint(0, cfg.vocab_size, (b, text), generator=gen,
                                device=DEV)
        front = {}
        if cfg.frontend != "none":
            front["frames" if cfg.is_enc_dec else "patch_embeds"] = (
                0.1 * torch.randn((b, cfg.frontend_len, cfg.d_model),
                                  generator=gen, device=DEV))
        serve = dict(dispatch=prof.moe_dispatch,
                     quantized_cache=prof.kv_int8)
        torch.cuda.synchronize()
        ops.reset_launches()
        P.reset_traffic()
        with flash_calls() as calls:
            res = serve_batch(cfg, params, prompts, n_dec + 1, device=DEV,
                              tp=tp, **serve, **front)
        rec = tp_serve_record(res, dict(ops.LAUNCHES), P.traffic(), n_dec)
        rec["flash_by_shape"] = by_shape(calls)
        tokens, force = res.tokens, None
        if one is not None:
            tokens = torch.tensor(json.loads(
                tp_out(tmp, one, 0).read_text())[arch]["tokens"])
            if cfg.num_experts:
                force = [[idx for idx, _ in step] for step in torch.load(
                    f"{tp_out(tmp, f'{one}_{arch}', 0)}.pt")["routes"]]
        out = tp_out(tmp, f"{tag}_{arch}", rank)
        rec.update(tp_serve_steps(cfg, arch, params, prompts, front, serve,
                                  tp, out, tokens.to(DEV), force))
        rec.update(param_bytes=sum(x.numel() * x.element_size()
                                   for x in tree_leaves(params)),
                   arch_s=time.perf_counter() - t0)
        if tp is not None:
            rec.update(rank=rank, model_rank=tp.rank)
        recs[arch] = rec
        del params, res, front, prompts
        gc.collect()
        torch.cuda.empty_cache()
    tp_out(tmp, tag, rank).write_text(json.dumps(recs))


def tp_serve_steps(cfg, arch: str, params, prompts, front: dict,
                   serve: dict, tp, out: Path, tokens, force=None) -> dict:
    """A prefill at :func:`tp_serve_cache` slots (whisper's frames encoded
    first, on the mesh where ``tp`` is one; pixtral's patches in front of
    the prompt), then the arch's decode steps fed ``tokens`` (the
    one-rank run's greedy tokens: decode step i feeds column i - 1 at the
    position after the prompt and i - 1 tokens, as ``serve_batch``
    does), each step's collectives timed (`parallel.timed`: the card
    synchronized around each).  ``force`` (a step's layers' (B, S, k)
    top-k experts: the one-rank run's routing) replaces each MoE layer's
    own top-k, its weights the router's probabilities at those experts
    made to sum to 1 (the softmax over their logits).  Returns the prefill's and the first
    decode step's seconds, collective seconds and bytes by axis and gloo
    share; the logits (B, 1 + steps, V) f32 (this rank's vocab slice,
    every column with ``tp`` None) and, for a MoE arch, every step's
    routing (each layer's (B, S, k) top-k experts, sorted, and (B, S, E)
    log probabilities: the layer's own, before ``force``) go to ``out +
    ".pt"``."""
    import torch
    from repro_torch.models import decode_step
    from repro_torch.models import moe
    from repro_torch.models.model import prefill_last
    from repro_torch.models.transformer import encode
    from repro_torch.sharding import parallel as P
    off = cfg.frontend_len if "patch_embeds" in front else 0
    text = prompts.shape[1]
    routes = []                    # a step's layers: (top-k, log probs)
    real = moe.router_probs

    def recording(*args, **kw):
        got = real(*args, **kw)
        routes[-1].append((got[1].sort(-1).values.cpu(),
                           got[2].log().cpu()))
        if force is None:
            return got
        idx = force[len(routes) - 1][len(routes[-1]) - 1].to(got[1].device)
        w = got[2].gather(-1, idx)
        return w / w.sum(-1, keepdim=True), idx, got[2]
    timed, rows = {}, []
    moe.router_probs = recording
    try:
        with torch.inference_mode():
            for i in range(TP_SERVES[arch][3] + 1):
                routes.append([])
                P.reset_traffic()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with P.timed() as secs:
                    if i == 0:
                        batch, enc = {"tokens": prompts}, None
                        if "frames" in front:
                            enc = encode(cfg, params, front["frames"],
                                         mode="prefill", tp=tp)
                            batch["enc_out"] = enc
                        if off:
                            batch["patch_embeds"] = front["patch_embeds"]
                        logits, caches = prefill_last(
                            cfg, params, batch, tp_serve_cache(arch), tp=tp,
                            **serve)
                    else:
                        logits, caches = decode_step(
                            cfg, params, caches, tokens[:, i - 1:i],
                            off + text + i - 1, enc_out=enc, tp=tp,
                            dispatch=serve["dispatch"])
                        logits = logits[:, 0]
                    torch.cuda.synchronize()
                    s = time.perf_counter() - t0
                    coll = dict(secs)
                if i < 2:
                    timed["decode" if i else "prefill"] = {
                        "s": s, "collective_s": coll,
                        "gloo_share": sum(coll.values()) / s if coll
                        else 0.0,
                        "bytes_by_axis": P.traffic()}
                rows.append(logits.float().cpu())
            del caches, enc
    finally:
        moe.router_probs = real
    torch.save({"logits": torch.stack(rows, 1), "routes": routes},
               f"{out}.pt")
    return {"timed_steps": timed}


def tp_families_phase(smi: str, tmp: Path, gen) -> tuple:
    """Tensor parallelism for the mixtures of experts (per-expert TP), the
    encoder-decoder (its encoder and cross-attention) and the vision
    front end (its patch projection) on the card: grok-1-314b,
    whisper-large-v3 and pixtral-12b at full width, served on a (1, 2)
    mesh of two spawned ranks sharing the card over gloo, each held
    against the same weights on one rank without a mesh
    (:func:`hold_serve`: the prefill's and every decode step's logits,
    the greedy tokens); grok-1's prefill routing compared layer by layer;
    then flash at a rank's heads (grok-1's layer, whisper's encoder and
    its cross-attention in decode).  Returns the phase line, the flash
    rows and the flash launches a rank made at their shapes on the serve
    path."""
    import torch
    tmp = tmp.resolve()
    t_phase = time.perf_counter()
    one = tp_spawn(tp_serve_rank, 1, tmp, "tpf_one", TPF_ARCHS)[0]
    world = TP_MESH[0] * TP_MESH[1]
    t0 = time.perf_counter()
    ranks = tp_spawn(tp_serve_rank, world, tmp, "tpf_mesh", TPF_ARCHS,
                     "tpf_one")
    mesh_wall = time.perf_counter() - t0
    archs = {}
    for arch in TPF_ARCHS:
        cfg, prof = tp_serve_config(arch)
        _, b, text, n_dec, _ = TP_SERVES[arch]
        want = torch.load(f"{tp_out(tmp, f'tpf_one_{arch}', 0)}.pt")
        parts = [torch.load(f"{tp_out(tmp, f'tpf_mesh_{arch}', r)}.pt")
                 for r in range(world)]
        got = torch.cat([p["logits"] for p in parts], -1)
        recs = [r[arch] for r in ranks]
        for r in recs:
            assert r["flash_by_shape"] == one[arch]["flash_by_shape"], (
                r["flash_by_shape"], one[arch]["flash_by_shape"])
        held = hold_serve(cfg, want["logits"], got, one[arch], recs)
        routing = (hold_routing(cfg, want["routes"],
                                [p["routes"] for p in parts])
                   if cfg.num_experts else None)
        archs[arch] = {
            "layers": cfg.num_layers,
            "encoder_layers": cfg.encoder_layers or None,
            "reduced": tp_serve_reduced(arch),
            "batch": b, "text": text,
            "frontend_len": cfg.frontend_len or None,
            "decode_steps": n_dec, "kv_int8": prof.kv_int8,
            "moe_dispatch": prof.moe_dispatch if cfg.num_experts else None,
            **held, "routing_vs_one_rank": routing,
            "one_rank": one[arch], "ranks": recs}
    flash = check_flash_frontend(gen, FLASH_TPF)
    grok, whisper = ranks[0]["grok-1-314b"], ranks[0]["whisper-large-v3"]
    launches = {
        "grok_tp": grok["flash_by_shape"].get("4096x4096, causal", 0),
        "whisper_encoder_tp": whisper["flash_by_shape"].get(
            "1500x1500, non-causal", 0),
        "whisper_cross_decode_tp": whisper["flash_by_shape"].get(
            "1x1500, non-causal", 0)}
    g_layers, w_layers = (TP_SERVES[a][0] for a in ("grok-1-314b",
                                                    "whisper-large-v3"))
    assert launches == {"grok_tp": g_layers, "whisper_encoder_tp": w_layers,
                        "whisper_cross_decode_tp":
                            w_layers * TP_SERVES["whisper-large-v3"][3]}, \
        launches
    line = {"phase": "tp_families", "nvidia_smi": smi,
            "backend": "gloo over CUDA tensors (ranks share the card)",
            "mesh": {"data": TP_MESH[0], "model": TP_MESH[1]},
            "archs": archs, "ranks_wall_s": mesh_wall,
            "flash_tp": flash, "phase_s": time.perf_counter() - t_phase}
    return line, flash, launches


def check_flash_tp_recurrent(gen) -> dict:
    """Row 4l: the bf16 flash kernel at one recurrentgemma-2b rank's local
    layer on the (1, 2) mesh (FLASH_TPR: B = 2, Hq = 5 over Hkv = 1, S =
    4096, D = 256, window 2048, causal), held against the plain version
    at gemma2's layer bars and timed beside ``flex_attention`` with the
    band mask, as row 4b is."""
    import torch
    b, hq, hkv, s, d, window = FLASH_TPR
    q, k, v = (torch.randn((b, s, h, d), generator=gen, device=DEV)
               .bfloat16().transpose(1, 2) for h in (hq, hkv, hkv))
    row = bf16_flash_layer(q, k, v, window, 0.0,
                           flex_attention_call(s, window, 0.0))
    row.update(tol={"rtol": FLASH_LAYER_RTOL_BF16,
                    "atol": FLASH_LAYER_ATOL_BF16},
               library="flex_attention (band block mask, enable_gqa; "
                       "torch.compile)",
               shape=f"one recurrentgemma-2b local layer on one rank of a "
                     f"(1, 2) mesh: B={b}, Hq={hq}, Hkv={hkv}, S={s}, "
                     f"D={d}, window {window}, bf16, no soft-cap")
    del q, k, v
    gc.collect()
    torch.cuda.empty_cache()
    return row


def tp_recurrent_phase(smi: str, tmp: Path, gen) -> tuple:
    """Tensor parallelism for the recurrent pair on the card: mamba2-1.3b
    (the SSD by heads, its projection and conv cut part by part) and
    recurrentgemma-2b (the RG-LRU by channels, its local attention on a
    rank's heads) at full width, served on a (1, 2) mesh of two spawned
    ranks sharing the card over gloo, each held against the same weights
    on one rank without a mesh (:func:`hold_serve`: the prefill's and
    every decode step's logits, fed one rank's tokens, and the greedy
    tokens), and mamba2-1.3b in float32 (TPR_F32) the same way at
    TPR_F32_TOL; the flash launches of a rank's prefill at recurrentgemma's
    rank shape, one a local layer; then that kernel at that shape (row
    4l).  Returns the phase line, row 4l and the flash launches a rank
    made at its shape on the serve path."""
    import torch
    tmp = tmp.resolve()
    t_phase = time.perf_counter()
    one = tp_spawn(tp_serve_rank, 1, tmp, "tpr_one", TPR_RUNS)[0]
    world = TP_MESH[0] * TP_MESH[1]
    t0 = time.perf_counter()
    ranks = tp_spawn(tp_serve_rank, world, tmp, "tpr_mesh", TPR_RUNS,
                     "tpr_one")
    mesh_wall = time.perf_counter() - t0
    archs = {}
    for arch in TPR_RUNS:
        cfg, prof = tp_serve_config(arch)
        _, b, text, n_dec, _ = TP_SERVES[arch]
        want = torch.load(f"{tp_out(tmp, f'tpr_one_{arch}', 0)}.pt")
        got = torch.cat([torch.load(
            f"{tp_out(tmp, f'tpr_mesh_{arch}', r)}.pt")["logits"]
            for r in range(world)], -1)
        recs = [r[arch] for r in ranks]
        local = cfg.layer_kinds().count("local")
        flash = {f"{text}x{text}, causal": local} if local else {}
        for r in recs + [one[arch]]:
            assert r["flash_by_shape"] == flash, (arch, r["flash_by_shape"])
        held = hold_serve(cfg, want["logits"], got, one[arch], recs,
                          TPR_BARS[arch])
        prefill = [r["timed_steps"]["prefill"] for r in recs]
        archs[arch] = {
            "layers": cfg.num_layers, "reduced": tp_serve_reduced(arch),
            "batch": b, "prompt": text, "decode_steps": n_dec,
            **held,
            "prefill_bytes_by_axis": prefill[0]["bytes_by_axis"],
            "prefill_gloo_share": [p["gloo_share"] for p in prefill],
            "prefill_s": [p["s"] for p in prefill],
            "decode_s_per_step": [r["decode_s_per_step"] for r in recs],
            "peak_device_mem_mb": [r["peak_device_mem_mb"] for r in recs],
            "one_rank": one[arch], "ranks": recs}
    flash_row = check_flash_tp_recurrent(gen)
    launches = ranks[0]["recurrentgemma-2b"]["flash_by_shape"][
        f"{FLASH_TPR[3]}x{FLASH_TPR[3]}, causal"]
    line = {"phase": "tp_recurrent", "nvidia_smi": smi,
            "backend": "gloo over CUDA tensors (ranks share the card)",
            "mesh": {"data": TP_MESH[0], "model": TP_MESH[1]},
            "archs": archs, "ranks_wall_s": mesh_wall,
            "flash_tp": flash_row,
            "phase_s": time.perf_counter() - t_phase}
    return line, flash_row, launches


def events_ms(fn, reps: int = 5, warmup: int = 1) -> float:
    """Median time of one call between CUDA events, each call's outputs
    dropped before the next (a stage-1 of gemma2-2b makes 10.5 GB: a CUDA
    graph of many calls would hold them all)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bf16_ulp(x):
    """One bf16 ulp at each element of the f32 tensor ``x``: 2^(e - 7)
    for |x| in [2^e, 2^(e+1)), the normal range's floor below it."""
    import torch
    _, e = torch.frexp(x)
    return torch.ldexp(torch.ones_like(x), (e - 8).clamp_min(-133))


def plain_tree(leaves, wm):
    """The plain stage-1 (``kernels/ref.py``) leaf by leaf, in column
    chunks of TRAIN_CHUNK (the embedding's f32 copy would be 9.4 GB)."""
    from repro_torch.kernels import ref
    outs = []
    for x in leaves:
        flat = x.reshape(x.shape[0], -1)
        outs.append([ref.weighted_agg_multi_ref(flat[:, a:a + TRAIN_CHUNK], wm)
                     for a in range(0, flat.shape[1], TRAIN_CHUNK)])
    return outs


def rows_apart(leaves, rows, kept) -> dict:
    """Rows ``rows`` of the (C, ...) leaves on the card against the same
    rows of another run kept on the host, in column chunks: the largest
    distance in bf16 ulps of the larger magnitude, and how many elements
    differ at all."""
    import torch
    worst, n_diff, n = 0.0, 0, 0
    for x, host in zip(leaves, kept):
        for i, h in zip(rows, host):
            a, b = x[i].reshape(-1), h.reshape(-1)
            for s in range(0, a.numel(), TRAIN_CHUNK):
                u = a[s:s + TRAIN_CHUNK].float()
                v = b[s:s + TRAIN_CHUNK].to(DEV).float()
                d = (u - v).abs()
                worst = max(worst, float(
                    (d / bf16_ulp(torch.maximum(u.abs(), v.abs()))).max()))
                n_diff += int((d > 0).sum())
            n += a.numel()
    return {"max_ulps": worst, "elements_differing": n_diff,
            "elements": n}


def stage1_on_stack(stack, losses, data_sizes, assignment, k) -> dict:
    """The round's stage-1 on its own stack: the kernel (one grouped
    launch a dtype) against the plain version leaf by leaf and in column
    chunks, every bf16 element within one bf16 ulp of the f32-accumulated
    sum (f32 leaves, as the recurrent families' ``A_log``, at WAGG_TOL);
    then the kernel, the plain version and one ``torch.matmul`` a leaf
    timed beside the byte bound.  The caller restores the launch counts."""
    import torch
    from repro_torch.core import aggregation
    from repro_torch.kernels import ops, ref
    from repro_torch.tree import tree_leaves
    t0 = time.perf_counter()
    one_hot = aggregation.membership_one_hot(assignment, k)
    w = aggregation.cluster_weights(losses, data_sizes, assignment, k,
                                    one_hot=one_hot)
    wm = (one_hot * w.float()[:, None]).contiguous()
    leaves = tree_leaves(stack)
    c = leaves[0].shape[0]
    before = ops.LAUNCHES["weighted_agg_multi"]
    got = ops.weighted_agg_multi_tree(tuple(leaves), wm)
    torch.cuda.synchronize()
    n_launches = ops.LAUNCHES["weighted_agg_multi"] - before
    max_err, worst_ulps, n = 0.0, 0.0, 0
    for g, x in zip(got, leaves):
        assert g.dtype == x.dtype, (g.dtype, x.dtype)
        flat, gf = x.reshape(c, -1), g.reshape(k, -1)
        for a in range(0, flat.shape[1], TRAIN_CHUNK):
            xs = flat[:, a:a + TRAIN_CHUNK]
            out = gf[:, a:a + TRAIN_CHUNK].float()
            want = wm.float().T @ xs.float()       # f32 accumulation
            if x.dtype == torch.bfloat16:
                ulps = float(((out - want).abs() / bf16_ulp(want)).max())
                worst_ulps = max(worst_ulps, ulps)
            else:
                assert x.dtype == torch.float32, x.dtype
                torch.testing.assert_close(out, want, rtol=WAGG_TOL,
                                           atol=WAGG_TOL)
            max_err = max(max_err, float(
                (out - ref.weighted_agg_multi_ref(xs, wm).float())
                .abs().max()))
        n += flat.shape[1]
    assert worst_ulps <= 1.0, worst_ulps
    del got
    check_s = time.perf_counter() - t0
    wmt = {dt: wm.T.contiguous().to(dt) for dt in {x.dtype for x in leaves}}
    n_bytes = sum(stage1_bytes(c, k, [x[0].numel()], x.element_size())
                  for x in leaves)
    n_ops = 2 * c * k * n
    row = {"max_abs_err": max_err, "max_ulps_vs_f32": worst_ulps,
           "ms": events_ms(lambda: ops.weighted_agg_multi_tree(
               tuple(leaves), wm)),
           "plain_ms": events_ms(lambda: plain_tree(leaves, wm), reps=3),
           "library_ms": events_ms(lambda: [
               torch.matmul(wmt[x.dtype], x.reshape(c, -1))
               for x in leaves], reps=3),
           "bound_ms": max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOPS)
           * 1e3,
           "bound_by": ("bytes" if n_bytes / HBM_BYTES_PER_S
                        >= n_ops / F32_FLOPS else "operations"),
           "bytes": n_bytes, "columns": n, "leaves": len(leaves),
           "dtypes": sorted(str(dt)[6:] for dt in wmt),
           "launches": n_launches, "C": c, "K": k, "check_s": check_s}
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    row["timed_s"] = time.perf_counter() - t0 - check_s
    return row


def profile_training(cfg, round_s: float, microbatches: int,
                     dispatch: str = "dense") -> dict:
    """Where a training round's time goes: one client's microbatch of the
    train step (``loss_fn`` with remat, gradients of every leaf; 4096
    tokens) under torch.profiler beside its unprofiled time, and the layer
    cores timed alone as a microbatch runs them (the checkpoint's forward
    without autograd, then the recompute and its backward): the train
    attention of a global and a local layer (gemma2-2b; recurrentgemma-2b's
    local layers; whisper-large-v3's causal decoder layers; mixtral-8x22b's
    sliding-window layers), the SSD's chunked core with its (B, nc, H, Q,
    Q) f32 decay matrices (mamba2-1.3b), the RG-LRU's log-depth scan
    (recurrentgemma-2b) and a mixture of experts' layer in ``dispatch``
    (the scan: every expert's three GEMMs on every token, each expert
    under its own checkpoint inside the layer's, so its forward runs three
    times and its backward once: 5 forwards' worth of GEMM flop);
    ``round_s`` and ``microbatches`` (a round's) give their shares of a
    round.  The GEMM kernels' share of the microbatch's device time is
    read from the profile."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import train as train_lib
    from repro_torch.models import attention as attn
    from repro_torch.models import loss_fn
    from repro_torch.models import moe, rglru, ssm
    from repro_torch.tree import tree_leaves, tree_unflatten
    seq = 4096
    model = train_lib.init_model(cfg, 0, DEV)
    gen = torch.Generator(device=DEV).manual_seed(5)
    toks = torch.randint(0, 256, (1, seq), generator=gen, device=DEV)

    batch = {"tokens": toks, "labels": toks}
    if cfg.is_enc_dec:        # the frames launch/train.py draws
        batch["frames"] = 0.1 * torch.randn(
            (1, cfg.frontend_len, cfg.d_model), generator=gen, device=DEV)

    def micro():
        ps = [x.detach().requires_grad_(True) for x in tree_leaves(model)]
        loss, _ = loss_fn(cfg, tree_unflatten(model, ps), batch,
                          dispatch=dispatch, remat=True)
        torch.autograd.grad(loss, ps)
    micro_ms = events_ms(micro, reps=3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        micro()
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    busy = sum(k[0] for k in kernels)
    f32_gemm = sum(k[0] for k in kernels
                   if "f32f32_f32f32" in k[1] or "sgemm" in k[1])
    gemm = kernel_summary(kernels, micro_ms)["gemm_ms"]
    # a MoE layer's weights: the first cycle's of the first pattern
    # position (the leading dim of model["layers"][0] is the cycle)
    moe_p = ({key: w[0] for key, w in model["layers"][0]["moe"].items()}
             if cfg.num_experts else None)
    if moe_p is None:
        del model

    def remat_ms(fn, *inputs):
        """``fn`` as a remat'd microbatch runs it: forward without
        autograd, then the recompute and its backward."""
        def once():
            with torch.no_grad():
                fn(*inputs)
            leaves = [t.detach().requires_grad_(t.is_floating_point())
                      for t in inputs]
            out = fn(*leaves)
            out = out[0] if isinstance(out, tuple) else out
            torch.autograd.grad(out, [t for t in leaves if t.requires_grad],
                                torch.ones_like(out))
        return events_ms(once, reps=3)

    kinds = cfg.layer_kinds()
    cores = {}
    pos = torch.arange(seq, dtype=torch.int32, device=DEV)
    if any(kd in ("attn", "global", "local", "swa") for kd in kinds):
        hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        q = torch.randn((1, seq, hq, d), generator=gen, device=DEV).bfloat16()
        k, v = (torch.randn((1, seq, hkv, d), generator=gen, device=DEV)
                .bfloat16() for _ in range(2))
        for kind in ("global", "local", "swa", "attn"):
            if kind not in kinds:
                continue
            if kind in ("local", "swa"):
                cores[f"attention_{kind}"] = (kinds.count(kind), remat_ms(
                    lambda q, k, v: attn.windowed_full_attention(
                        cfg, q, k, v, pos, pos, cfg.window_size), q, k, v))
            else:           # a global layer, or whisper's decoder layer
                cores[f"attention_{kind}"] = (kinds.count(kind), remat_ms(
                    lambda q, k, v: attn.chunk_attention(
                        cfg, q, k, v, pos, pos, causal=True), q, k, v))
    if "ssd" in kinds:
        h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        x = torch.randn((1, seq, h, p), generator=gen, device=DEV).bfloat16()
        dt = torch.rand((1, seq, h), generator=gen, device=DEV) * 0.1
        bm, cm = (torch.randn((1, seq, n), generator=gen, device=DEV)
                  .bfloat16() for _ in range(2))
        a = -torch.linspace(1.0, 16.0, h, device=DEV)
        cores["ssd_chunked"] = (kinds.count("ssd"), remat_ms(
            lambda x, dt, bm, cm, a: ssm._ssd_chunked(cfg, x, dt, bm, cm,
                                                      a), x, dt, bm, cm, a))
    if "rglru" in kinds:
        w = cfg.lru_width
        a = torch.rand((1, seq, w), generator=gen, device=DEV)
        b = torch.randn((1, seq, w), generator=gen, device=DEV)
        cores["rglru_scan"] = (kinds.count("rglru"),
                               remat_ms(rglru.linear_scan, a, b))
    expert_tflop_per_s = None
    if moe_p is not None:
        x = torch.randn((1, seq, cfg.d_model), generator=gen,
                        device=DEV).to(moe_p["w_gate"].dtype)
        keys = ("router", "w_gate", "w_up", "w_down")
        cores[f"moe_{dispatch}"] = (cfg.num_layers, remat_ms(
            lambda x, *w: moe.apply_moe(cfg, dict(zip(keys, w)), x,
                                        dispatch)[0],
            x, *(moe_p[key] for key in keys)))
        if dispatch == "scan":      # every expert on every token, 5 passes
            flop = (5 * cfg.num_experts * 3 * 2 * seq * cfg.d_model
                    * cfg.d_ff)
            expert_tflop_per_s = flop / (cores["moe_scan"][1] * 1e-3) / 1e12
        del model, moe_p, x
    per_micro = {name: n * ms for name, (n, ms) in cores.items()}
    out = {"microbatch_ms": micro_ms, "device_busy_ms": busy,
           "device_idle_share": 1.0 - busy / micro_ms,
           "f32_gemm_ms": f32_gemm, "gemm_ms": gemm,
           "gemm_share_of_busy": gemm / busy,
           "moe_layer_tflop_per_s": expert_tflop_per_s,
           "kernel_launches": sum(k[2] for k in kernels),
           "layer_core_ms": {name: ms for name, (_, ms) in cores.items()},
           "layer_core_ms_per_microbatch": per_micro,
           "layer_core_share_of_round": {
               name: microbatches * ms / (round_s * 1e3)
               for name, ms in per_micro.items()},
           "top": [{"name": k[1][:90], "device_ms": k[0], "count": k[2]}
                   for k in kernels[:10]]}
    att = [ms for name, ms in per_micro.items()
           if name.startswith("attention")]
    if att:             # the attention readings under their earlier keys
        out["attention_layer_ms"] = {
            name.split("_")[1]: ms for name, (_, ms) in cores.items()
            if name.startswith("attention")}
        out["attention_ms_per_microbatch"] = sum(att)
        out["attention_share_of_microbatch"] = sum(att) / micro_ms
        out["attention_share_of_round"] = (microbatches * sum(att)
                                           / (round_s * 1e3))
    return out


def train_layout(arch: str) -> tuple:
    """(clients, clusters, global batch) of this script's training run of
    ``arch``."""
    if arch == MOE_TRAIN_ARCH:
        return MOE_TRAIN_CLIENTS, MOE_TRAIN_CLUSTERS, MOE_TRAIN_BATCH
    return TRAIN_CLIENTS, TRAIN_CLUSTERS, TRAIN_BATCH


def train_phase(smi: str, arch: str = TRAIN_ARCH, rounds: int = TRAIN_ROUNDS,
                rerun: int = TRAIN_RERUN, layers: int | None = None, *,
                clients: int = TRAIN_CLIENTS,
                clusters: int = TRAIN_CLUSTERS,
                global_batch: int = TRAIN_BATCH) -> tuple:
    """FL training of ``arch`` at full width (and depth, but ``layers``)
    through ``repro_torch.launch.train.train``, ``clients`` clients in
    ``clusters`` clusters at ``global_batch`` rows: ``rounds`` rounds with
    the kernels on (round 1's stage-1 held against the plain version and
    timed on its own stack), one stage-1 launch a round for each dtype of
    the model's leaves, then the first ``rerun`` rounds again with the
    kernels off from the same start and batches, each round's aggregated
    clients held against the first run's (``held``).  A mixture of
    experts' line is phase ``train_moe``.  Returns the phase line and the
    kernels row."""
    import torch
    from repro_torch.configs import (depth_cut, get_config, get_profile,
                                     replace)
    from repro_torch.core import aggregation
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_lib
    from repro_torch.tree import tree_leaves
    cfg = get_config(arch)
    if layers:
        cfg = depth_cut(cfg, layers)
    prof = get_profile(arch)
    cfg = replace(cfg, dtype=prof.param_dtype)
    model = train_lib.init_model(cfg, 0, DEV)
    start = model["embed"]["embedding"].clone()
    groups = len(ops.dtype_groups(tree_leaves(model)))
    del model
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()

    stage1, per_round, changed, kept, apart = {}, [], [], [], []
    check_s = {True: [], False: []}     # a round's seconds in the checks
    unwrapped = aggregation.hierarchical_round

    def held(stack, losses, data_sizes, assignment, k, *args, **kw):
        """Each round's aggregation, in both runs.  Kernels on: round 1's
        local updates not all rounded away (each client's embedding
        against the start), its stage-1 held and timed on its own stack,
        the launches a round counted, and the first member's row of each
        cluster kept on the host for the first ``rerun`` rounds.
        Kernels off: those rows against the kept ones.  The checks' time
        (synced) goes to ``check_s``: the round's own time is the rest."""
        use_kernels = kw.get("use_kernels")
        r = len(check_s[use_kernels])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if use_kernels and r == 0:
            emb = stack["embed"]["embedding"]
            changed.extend(int((emb[i] != start).sum())
                           for i in range(emb.shape[0]))
            counts = dict(ops.LAUNCHES)
            stage1.update(stage1_on_stack(stack, losses, data_sizes,
                                          assignment, k))
            ops.LAUNCHES.update(counts)
            gc.collect()
            torch.cuda.empty_cache()
        before = ops.LAUNCHES["weighted_agg_multi"]
        spent = time.perf_counter() - t0
        out = unwrapped(stack, losses, data_sizes, assignment, k, *args,
                        **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = [int((assignment == j).nonzero()[0]) for j in range(k)]
        if use_kernels:
            per_round.append(ops.LAUNCHES["weighted_agg_multi"] - before)
            if r < rerun:
                kept.append([[x[i].to("cpu", copy=True) for i in rows]
                             for x in tree_leaves(out)])
        else:
            apart.append(rows_apart(tree_leaves(out), rows, kept[r]))
        torch.cuda.synchronize()
        check_s[use_kernels].append(spent + time.perf_counter() - t0)
        return out

    def run(n_rounds, use_kernels):
        gc.collect()
        torch.cuda.empty_cache()
        ops.reset_launches()
        return train_lib.train(
            arch, rounds=n_rounds, clusters=clusters,
            rounds_per_global=TRAIN_RPG, clients=clients,
            global_batch=global_batch, seed=0, device=DEV,
            use_kernels=use_kernels, layers=layers)

    aggregation.hierarchical_round = held
    try:
        on = run(rounds, True)
        launches = dict(ops.LAUNCHES)
        finite = all(bool(torch.isfinite(x).all())
                     for x in tree_leaves(on.stack))
        on = on._replace(stack=None)
        off = run(rerun, False)
    finally:
        aggregation.hierarchical_round = unwrapped
    off_launches = dict(ops.LAUNCHES)
    off = off._replace(stack=None)
    del start, kept
    gc.collect()
    torch.cuda.empty_cache()

    assert stage1, "round 1's stage-1 was not held"
    assert per_round == [groups] * rounds, per_round
    assert launches["weighted_agg_multi"] == groups * rounds, launches
    assert launches["flash_attention"] == 0, launches   # train: chunked
    assert set(off_launches.values()) == {0}, off_launches
    assert finite, "the final client stack holds a non-finite value"
    assert [r.did_global for r in on.rounds] == [
        (r + 1) % TRAIN_RPG == 0 for r in range(rounds)]
    ces = [r.ce for r in on.rounds]
    assert all(math.isfinite(x) for x in ces), ces
    assert all(n > 0 for n in changed) and len(changed) == clients, changed
    off_ces = [r.ce for r in off.rounds]
    assert off_ces[0] == ces[0], (off_ces, ces)
    assert all(abs(a - b) <= TRAIN_CE_RTOL * abs(b)
               for a, b in zip(off_ces[1:], ces[1:])), (off_ces, ces)
    assert len(apart) == rerun and all(
        a["max_ulps"] <= TRAIN_STACK_ULPS for a in apart), apart
    emb_cols = cfg.vocab_padded * cfg.d_model
    own_s = [r.s - c for r, c in zip(on.rounds, check_s[True])]
    steady_s = statistics.median(own_s[1:])
    where = profile_training(cfg, steady_s, clients * on.meta["accum"],
                             prof.moe_dispatch)
    gc.collect()
    torch.cuda.empty_cache()
    line = {
        "phase": "train_moe" if cfg.num_experts else "train",
        "arch": cfg.name, "layers": cfg.num_layers,
        "encoder_layers": cfg.encoder_layers,
        "reduced": (f"depth cut to {layers} layer{'s' * (layers > 1)}"
                    if layers else None),
        "d_model": cfg.d_model, "vocab": cfg.vocab_size,
        "params": on.meta["params"], "dtype": on.meta["dtype"],
        "clients": clients, "clusters": on.clusters,
        "seq": on.meta["seq"], "global_batch": on.meta["global_batch"],
        "accum": on.meta["accum"], "micro": on.meta["micro"],
        "accum_dtype": prof.accum_dtype, "remat": prof.remat,
        "moe_dispatch": prof.moe_dispatch if cfg.num_experts else None,
        "rounds_per_global": TRAIN_RPG, "lr": on.meta["lr"],
        "nvidia_smi": smi, "ln_vocab": math.log(cfg.vocab_size),
        "rounds": [r._asdict() for r in on.rounds],
        "check_s": check_s[True], "rounds_less_checks_s": own_s,
        "peak_device_mem_mb": on.peak_device_mem_mb,
        "launches": launches, "launches_per_round": per_round,
        "embedding_changed_after_round1": changed,
        "embedding_changed_share": [n / emb_cols for n in changed],
        "kernels_off": {"rounds": [r._asdict() for r in off.rounds],
                        "check_s": check_s[False],
                        "peak_device_mem_mb": off.peak_device_mem_mb,
                        "launches": off_launches,
                        "ce_rtol": TRAIN_CE_RTOL,
                        "round1_ce_equal": off_ces[0] == ces[0],
                        "ce_rel_diff": [abs(a - b) / abs(b) for a, b
                                        in zip(off_ces, ces)],
                        "stack_ulps_bar": TRAIN_STACK_ULPS,
                        "stacks_apart": apart},
        "stage1": stage1, "steady_round_s": steady_s,
        "where_the_time_goes": where}
    line["stage1_launches_per_round"] = groups
    row = {"name": "weighted_agg_multi_train" + (
               "" if arch == TRAIN_ARCH else "_" + arch.split("-")[0]),
           "route": "cuda",
           "source": "src/repro_torch/csrc/weighted_agg.cu",
           "replaces": "src/repro/kernels/weighted_agg.py:76",
           "launches": launches["weighted_agg_multi"],
           **{key: stage1[key] for key in (
               "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms")},
           "shape": f"one stage-1 of the {arch} FL round: "
                    f"{stage1['leaves']} leaves, C={stage1['C']}, "
                    f"K={stage1['K']}, {'+'.join(stage1['dtypes'])}, "
                    f"{stage1['columns']} columns, {groups} launch"
                    f"{'es' if groups > 1 else ''}"}
    return line, row


def dryrun_count(task) -> tuple:
    """One dry-run count in a worker process of ``dryrun_phase``: the
    record, and the kernel launches the worker counted (none)."""
    key, arch, shape, kw = task
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    return key, dryrun.run_one(arch, shape, **kw), dict(ops.LAUNCHES)


def start_dryrun():
    """Start the counts of :func:`dryrun_phase` in DRYRUN_WORKERS spawned
    processes, the longest first: every training and serve run of this
    script at its own config and shape (a training round at C, K, the
    global batch and the stage-2 cadence of the train phase; a serve's
    prefill step at its batch and prompt, with the MoE depth cuts), and a
    smoke count on ``cuda`` and on ``meta`` (where a host without CUDA
    counts).  The caller starts them before the training phases, which
    keep the card busy and leave the host's cores free, and shuts the
    pool down.  Returns (pool, futures, start time)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    tasks = []
    for arch in ((MOE_TRAIN_ARCH, TRAIN_ARCH) + RECURRENT_ARCHS
                 + FRONTEND_TRAIN_ARCHS):
        clients, clusters, batch = train_layout(arch)
        tasks.append((f"train {arch}", arch, "train_4k", dict(
            device="cuda", clients=clients, clusters=clusters,
            global_batch=batch, rounds_per_global=TRAIN_RPG,
            num_layers=(MOE_TRAIN_LAYERS if arch == MOE_TRAIN_ARCH
                        else TRAIN_LAYERS.get(arch)))))
    for arch in ("gemma2-2b",) + RECURRENT_ARCHS + MOE_ARCHS + FRONTEND_ARCHS:
        batch, text, _ = FRONTEND_SERVE.get(arch, (SERVE_BATCH, None, None))
        tasks.append((f"serve {arch}", arch, "prefill_32k", dict(
            device="cuda", batch=batch, num_layers=MOE_LAYERS.get(arch),
            seq_len=text if arch == "whisper-large-v3" else SERVE_PROMPT)))
    # the tp runs, each as rank 0 of its mesh
    for arch, (layers, batch, _, _, _) in TP_SERVES.items():
        if arch == TPR_F32:             # the dry run counts the profile's
            continue                    # dtype only
        key = ("tp serve" if arch == TP_ARCH else
               "tpr serve" if arch in TPR_ARCHS else "tpf serve")
        tasks.append((f"{key} {arch}", arch, "prefill_32k", dict(
            device="cuda", mesh="x".join(map(str, TP_MESH)), batch=batch,
            seq_len=tp_serve_cache(arch), num_layers=layers)))
    tasks.append((f"tp train {TP_TRAIN_ARCH}", TP_TRAIN_ARCH, "train_4k",
                  dict(device="cuda", mesh="x".join(map(str, TP_TRAIN_MESH)),
                       global_batch=TP_TRAIN_BATCH, clusters=1,
                       rounds_per_global=2, seq_len=TP_TRAIN_SEQ,
                       num_layers=TP_TRAIN_LAYERS)))
    for shape in ("train_4k", "prefill_32k"):
        for d in ("cuda", "meta"):
            tasks.append(((shape, d), "gemma2-2b", shape,
                          dict(smoke=True, device=d)))
    pool = ProcessPoolExecutor(DRYRUN_WORKERS, mp_context=multiprocessing
                               .get_context("spawn"))
    return pool, [pool.submit(dryrun_count, t) for t in tasks], \
        time.perf_counter()


def dryrun_phase(smi: str, serve_lines: dict, train_lines: list,
                 started, tp_line: dict, tpf_line: dict,
                 tpr_line: dict) -> dict:
    """The dry run of every serve and training run above
    (``repro_torch.launch.dryrun.run_one`` on the host, fake tensors on
    the card's device, counted by :func:`start_dryrun`'s workers): the
    predicted peak (``total_hbm_bytes``) against the run's measured
    ``peak_device_mem_mb``, which must lie within DRYRUN_PEAK_RATIO of it,
    and the counted flops over the run's measured seconds (a prefill's,
    with whisper's encode; a round's less the checks) as TFLOP/s and as a
    share of the card's dense bf16 peak.  The counts launch no kernel; the
    smoke counts on ``cuda`` and ``meta`` must agree exactly."""
    _, futures, t0 = started
    waited = time.perf_counter()
    done = [f.result() for f in futures]
    waited = time.perf_counter() - waited
    measured = {}
    for line in train_lines:
        assert (line["clients"], len(line["clusters"]), line["global_batch"],
                line["rounds_per_global"]) == (*train_layout(line["arch"]),
                                               TRAIN_RPG), line
        measured[f"train {line['arch']}"] = ([line], line["steady_round_s"])
    for arch, line in serve_lines.items():
        measured[f"serve {arch}"] = (line["runs"], statistics.median(
            r["prefill_s"] + r.get("encode_s", 0.0) for r in line["runs"]))
    # the tp runs: a rank's predicted peak against the largest rank's
    ranks = tp_line["serve"]["ranks"]
    measured[f"tp serve {TP_ARCH}"] = (ranks, statistics.median(
        r["prefill_s"] for r in ranks))
    ranks = tp_line["train"]["ranks"]
    measured[f"tp train {TP_TRAIN_ARCH}"] = (ranks, statistics.median(
        r["s"] for r in ranks))
    for key, phase in (("tpf", tpf_line), ("tpr", tpr_line)):
        for arch, line in phase["archs"].items():
            if arch == TPR_F32:
                continue
            measured[f"{key} serve {arch}"] = (
                line["ranks"], statistics.median(
                    r["prefill_s"] + r["encode_s"] for r in line["ranks"]))
    recs = {key: rec for key, rec, _ in done}
    launched = [(key, n) for key, _, n in done if set(n.values()) != {0}]
    assert not launched, launched
    same = {}
    for shape in ("train_4k", "prefill_32k"):
        on_cuda, on_meta = recs[(shape, "cuda")], recs[(shape, "meta")]
        for key in ("memory", "cost", "collectives"):
            assert on_cuda[key] == on_meta[key], (key, on_cuda, on_meta)
        same[shape] = on_cuda["cost"]["flops"]
    rows = []
    for key, (runs, seconds) in measured.items():
        rec = recs[key]
        assert rec["status"] == "ok", rec
        peak_mb = max(r["peak_device_mem_mb"] for r in runs)
        predicted = rec["memory"]["total_hbm_bytes"]
        flops = rec["cost"]["flops"]
        rows.append({
            "run": key, "layers": rec["meta"]["layers"],
            "predicted_peak_mb": predicted / 1e6,
            "measured_peak_mb": peak_mb,
            "predicted_over_measured": predicted / (peak_mb * 1e6),
            "argument_mb": rec["memory"]["argument_size_in_bytes"] / 1e6,
            "counted_flops": flops,
            "bytes_accessed": rec["cost"]["bytes_accessed"],
            "measured_s": seconds,
            "counted_tflop_per_s": flops / seconds / 1e12,
            "share_of_dense_bf16_peak": flops / seconds / BF16_FLOPS,
            "count_s": rec["count_s"],
            "trip_counts": rec["meta"]["trip_counts"]})
    lo, hi = DRYRUN_PEAK_RATIO
    off = [r for r in rows if not lo <= r["predicted_over_measured"] <= hi]
    assert not off, off
    assert len(rows) == len(measured) == len(done) - 4, (rows, done)
    return {"phase": "dryrun", "nvidia_smi": smi,
            "peak_ratio_bar": DRYRUN_PEAK_RATIO, "runs": rows,
            "cuda_equals_meta_smoke_flops": same, "workers": DRYRUN_WORKERS,
            "since_started_s": time.perf_counter() - t0,
            "waited_after_the_training_s": waited}


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
    flash_rg = check_flash_rg_local(gen)
    flash_moe = check_flash_moe(gen)
    flash_front = check_flash_frontend(gen)
    emit({"phase": "kernels_vs_plain", "weighted_agg_multi": wagg,
          "kmeans_assign": km, "weighted_agg": wagg1,
          "flash_attention": flash, "flash_attention_rg_local": flash_rg,
          "flash_attention_moe": flash_moe,
          "flash_attention_frontend": flash_front,
          "launch_floor_ms": km["launch_floor_ms"]})
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

    # ---- 5e. the client mesh at N = 800: W = 1 under NCCL, and two ranks
    # sharing the card over gloo; the counts are set to 0 before each run
    # and read after it, in the ranks too
    emit(mesh_phase(tmp))
    gc.collect()
    torch.cuda.empty_cache()

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
    serve_lines = {}
    serve_lines[cfg.name] = {
          "phase": "serve", "arch": cfg.name, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "params": param_count(params),
          "dtype": cfg.dtype, "batch": SERVE_BATCH, "prompt": SERVE_PROMPT,
          "new_tokens": SERVE_TOKENS, "init_s": init_s,
          "launches": serve_launches, "flash_routes": serve_routes,
          "runs": [{"prefill_s": r.prefill_s, "decode_s": r.decode_s,
                    "decode_tokens_per_s": r.decode_tokens_per_s,
                    "peak_device_mem_mb": r.peak_device_mem_mb}
                   for r in (first, second)],
          "first_tokens": first.tokens[:, :8].tolist()}
    emit(serve_lines[cfg.name])

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
    del params, prompts, first, second, sgen
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 8a. the recurrent families at full width and depth: mamba2-1.3b
    # (no flash launch) and recurrentgemma-2b (its 8 local layers through
    # the bf16 flash kernel); the counts are set to 0 before each serving
    # run and read after it
    rec_flash = {}
    for arch in RECURRENT_ARCHS:
        line, prof, rec_flash[arch] = serve_recurrent_phase(arch)
        serve_lines[arch] = line
        emit(line)
        emit(prof)
    assert rec_flash == {"mamba2-1.3b": 0, "recurrentgemma-2b": 8}, rec_flash

    # ---- 8b. the mixtures of experts at full width, depth cut: grok-1-314b
    # (4 layers, int8 cache) and mixtral-8x22b (8 layers, window 4096), every
    # layer's prefill through the bf16 flash kernel at D = 128, group 6; the
    # counts are set to 0 before each serving run and read after it
    moe_flash = {}
    for arch in MOE_ARCHS:
        line, prof, moe_flash[arch] = serve_moe_phase(arch)
        serve_lines[arch] = line
        emit(line)
        emit(prof)
    assert moe_flash == MOE_LAYERS, moe_flash

    # ---- 8b'. the front ends at full width and depth: whisper-large-v3
    # (encoder-decoder: the encoder, cross-attention in prefill and in every
    # decode step) and pixtral-12b (1024 patches before the text), every
    # attention of the prefill and the encode (and whisper's cross-attention
    # in decode) through the bf16 flash kernel; the counts are set to 0
    # before each serving run and read after it
    front_flash = {}
    for arch in FRONTEND_ARCHS:
        line, prof, rows_launched = serve_frontend_phase(arch)
        serve_lines[arch] = line
        emit(line)
        emit(prof)
        front_flash.update(rows_launched)
    dec_steps = FRONTEND_SERVE["whisper-large-v3"][2] - 1
    assert front_flash == {"whisper_encoder": 32, "whisper_cross": 32,
                           "whisper_cross_decode": 32 * dec_steps,
                           "pixtral": 40}, front_flash

    # ---- 8b''. tensor parallelism over "model": qwen2-72b served at full
    # width (4 layers) on a (1, 2) mesh, gemma2-2b trained one round on a
    # (2, 2) mesh, spawned ranks sharing the card over gloo, each against
    # one rank without a mesh; every rank's prefill through the bf16 flash
    # kernel on its heads (row 4h); the counts are set to 0 in each rank
    # just before its serve and read after it
    tp_line, flash_tp, tp_flash = tp_phase(smi, tmp, gen)
    emit(tp_line)

    # ---- 8b'''. tensor parallelism for the other families: grok-1-314b
    # (per-expert TP), whisper-large-v3 (encoder, cross-attention) and
    # pixtral-12b (patch projection) at full width on a (1, 2) mesh, each
    # against one rank; flash at a rank's heads (grok-1's layer, whisper's
    # encoder and cross-attention in decode); the counts are set to 0 in
    # each process just before each serve and read after it
    tpf_line, flash_tpf, tpf_flash = tp_families_phase(smi, tmp, gen)
    emit(tpf_line)

    # ---- 8b4. tensor parallelism for the recurrent pair: mamba2-1.3b (the
    # SSD by heads) and recurrentgemma-2b (the RG-LRU by channels, its
    # local layers through the bf16 flash kernel on a rank's heads) at full
    # width on a (1, 2) mesh, each against one rank; flash at that rank
    # shape (row 4l); the counts are set to 0 in each process just before
    # each serve and read after it
    tpr_line, flash_tpr, tpr_flash = tp_recurrent_phase(smi, tmp, gen)
    emit(tpr_line)

    # ---- 8c. transformer FL training: gemma2-2b, then the recurrent
    # families and whisper-large-v3, 4 clients on the card, stage-1 through
    # the kernel; the counts are set to 0 before each run and read after
    # it.  The dry run of every serve and training run counts on the
    # host's spare cores meanwhile (8d).
    started = start_dryrun()
    try:
        train_line, train_row = train_phase(
            smi, layers=TRAIN_LAYERS.get(TRAIN_ARCH))
        emit(train_line)
        train_rows = [train_row]
        train_lines = [train_line]
        for arch in RECURRENT_ARCHS + FRONTEND_TRAIN_ARCHS:
            line, row = train_phase(smi, arch, REC_TRAIN_ROUNDS,
                                    REC_TRAIN_RERUN, TRAIN_LAYERS.get(arch))
            emit(line)
            train_lines.append(line)
            train_rows.append(row)

        # ---- 8c'. mixture-of-experts FL training: mixtral-8x22b at full
        # width, 1 layer, C = 2 clients in K = 1 cluster, scan dispatch,
        # bf16 accumulator, stage-1 through the kernel (phase train_moe)
        clients, clusters, batch = train_layout(MOE_TRAIN_ARCH)
        line, row = train_phase(smi, MOE_TRAIN_ARCH, TRAIN_ROUNDS,
                                TRAIN_RERUN, MOE_TRAIN_LAYERS,
                                clients=clients, clusters=clusters,
                                global_batch=batch)
        emit(line)
        train_lines.append(line)
        train_rows.append(row)

        # ---- 8d. the dry run of every run above: its predicted peak
        # against the card's, its flops over the card's seconds
        emit(dryrun_phase(smi, serve_lines, train_lines, started, tp_line,
                          tpf_line, tpr_line))
    finally:
        started[0].shutdown(cancel_futures=True)

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
    # the same kernel at recurrentgemma-2b's local layers: 8 launches a
    # prefill of its serving run
    rows.append({"name": "flash_attention_rg_local", "route": "cuda",
                 "source": "src/repro_torch/csrc/flash_attention_sm90.cu",
                 "replaces": "src/repro/kernels/flash_attention.py:88",
                 "launches": rec_flash["recurrentgemma-2b"],
                 **{key: flash_rg[key] for key in (
                     "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                     "library_ms", "shape")}})
    # the same kernel at the MoE layers: one launch a layer of a prefill
    for kname, arch in (("flash_attention_grok", "grok-1-314b"),
                        ("flash_attention_mixtral", "mixtral-8x22b")):
        rows.append({"name": kname, "route": "cuda",
                     "source": "src/repro_torch/csrc/flash_attention_sm90.cu",
                     "replaces": "src/repro/kernels/flash_attention.py:88",
                     "launches": moe_flash[arch],
                     **{key: flash_moe[arch][key] for key in (
                         "max_abs_err", "ms", "plain_ms", "bound_ms",
                         "bound_by", "library_ms", "shape")}})
    # the same kernel at the front-end models' attention: whisper's
    # encoder, cross-attention in prefill and in decode, pixtral's layers
    for kname, key in (("flash_attention_whisper_encoder", "whisper_encoder"),
                       ("flash_attention_whisper_cross", "whisper_cross"),
                       ("flash_attention_whisper_cross_decode",
                        "whisper_cross_decode"),
                       ("flash_attention_pixtral", "pixtral")):
        rows.append({"name": kname, "route": "cuda",
                     "source": "src/repro_torch/csrc/flash_attention_sm90.cu",
                     "replaces": "src/repro/kernels/flash_attention.py:88",
                     "launches": front_flash[key],
                     **{k: flash_front[key][k] for k in (
                         "max_abs_err", "ms", "plain_ms", "bound_ms",
                         "bound_by", "library_ms", "shape")}})
    # the same kernel at qwen2-72b's heads on one rank of the (1, 2) mesh:
    # one launch a layer of each rank's prefill
    rows.append({"name": "flash_attention_qwen2_tp", "route": "cuda",
                 "source": "src/repro_torch/csrc/flash_attention_sm90.cu",
                 "replaces": "src/repro/kernels/flash_attention.py:88",
                 "launches": tp_flash,
                 **{k: flash_tp[k] for k in (
                     "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                     "library_ms", "shape")}})
    # the same kernel at a rank's heads of the tp_families serves: grok-1's
    # layer, whisper's encoder and its cross-attention in decode
    for key in FLASH_TPF:
        rows.append({"name": f"flash_attention_{key}", "route": "cuda",
                     "source": "src/repro_torch/csrc/flash_attention_sm90.cu",
                     "replaces": "src/repro/kernels/flash_attention.py:88",
                     "launches": tpf_flash[key],
                     **{k: flash_tpf[key][k] for k in (
                         "max_abs_err", "ms", "plain_ms", "bound_ms",
                         "bound_by", "library_ms", "shape")}})
    # the same kernel at one recurrentgemma-2b rank's local layer of the
    # tp_recurrent serve: one launch a local layer of each rank's prefill
    rows.append({"name": "flash_attention_rg_local_tp", "route": "cuda",
                 "source": "src/repro_torch/csrc/flash_attention_sm90.cu",
                 "replaces": "src/repro/kernels/flash_attention.py:88",
                 "launches": tpr_flash,
                 **{k: flash_tpr[k] for k in (
                     "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                     "library_ms", "shape")}})
    rows.extend(train_rows)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
