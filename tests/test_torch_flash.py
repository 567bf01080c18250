"""The port's ``flash_attention`` and ``weighted_agg`` against the JAX
reference, on the CPU.

Here the dispatching wrappers (`repro_torch/kernels/ops.py`) take the plain
PyTorch versions; those are held against the interpreted Pallas kernels on
the sweeps of ``tests/test_kernels.py``, at its tolerances (flash 3e-5 in
f32 and 4e-2 in bf16; weighted_agg 1e-5 and 3e-2).  The CUDA kernels are
held against the plain versions in ``tests/test_torch_cuda.py`` (skipped
without a card) and by ``chip_smoke.py`` on the card.
"""
import importlib.util
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)        # see test_torch_jaxref.py

# the reference's sweep (tests/test_kernels.py):
# B, Hq, Hkv, Sq, Sk, D, causal, window, softcap
CASES = [
    (1, 4, 2, 128, 128, 64, True, 0, 0.0),
    (2, 4, 4, 96, 96, 32, True, 0, 50.0),          # softcap (gemma2)
    (1, 8, 2, 256, 256, 64, True, 64, 0.0),        # sliding window
    (1, 2, 1, 1, 300, 64, True, 0, 0.0),           # decode: Sq=1
    (1, 2, 1, 1, 300, 64, True, 128, 0.0),         # decode + window
    (1, 2, 2, 128, 128, 64, False, 0, 0.0),        # bidirectional (encoder)
    (2, 2, 2, 70, 70, 128, True, 0, 0.0),          # non-multiple lengths
]


def _qkv(case, seed, dtype):
    b, hq, hkv, sq, sk, d = case[:6]
    g = np.random.default_rng(seed)
    arrs = [g.standard_normal(s).astype(np.float32)
            for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))]
    return ([jnp.asarray(a).astype(dtype) for a in arrs],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs])


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_flash_attention_matches_pallas_kernel(case, dt):
    """Plain version == the interpreted Pallas kernel == the JAX oracle, on
    the same inputs; output in q's dtype."""
    causal, window, cap = case[6:]
    (jq, jk, jv), (tq, tk, tv) = _qkv(case, CASES.index(case), dt)
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window,
                              softcap=cap)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    pallas = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                  softcap=cap, interpret=True)
    oracle = jref.flash_attention_ref(jq, jk, jv, causal=causal,
                                      window=window, softcap=cap)
    tol = 3e-5 if dt == "float32" else 4e-2
    for want in (pallas, oracle):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


# cross-attention and the encoder (whisper-large-v3's routes): non-causal,
# Sq != Sk, Sk = 1500 = 23 * 64 + 28 not a multiple of the kernel's kv tile
CROSS_CASES = [(2, 4, 4, 100, 1500, 64), (2, 4, 4, 1, 1500, 64)]


@pytest.mark.parametrize("case", CROSS_CASES)
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_flash_attention_non_causal_cross_matches_pallas_kernel(case, dt):
    """The plain version against the interpreted Pallas kernel and the JAX
    oracle without a mask, at the sweep's tolerances."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(case, 20 + CROSS_CASES.index(case), dt)
    got = ops.flash_attention(tq, tk, tv, causal=False)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    pallas = jops.flash_attention(jq, jk, jv, causal=False, interpret=True)
    oracle = jref.flash_attention_ref(jq, jk, jv, causal=False)
    tol = 3e-5 if dt == "float32" else 4e-2
    for want in (pallas, oracle):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def test_flash_attention_independent_of_the_reference_tiling():
    """The port's function equals the Pallas kernel at two block shapes
    (the reference's block-shape independence case)."""
    (jq, jk, jv), (tq, tk, tv) = _qkv((1, 2, 2, 200, 200, 64), 9, "float32")
    got = _f32(ops.flash_attention(tq, tk, tv))
    for bq, bk in ((128, 128), (64, 32)):
        want = jops.flash_attention(jq, jk, jv, block_q=bq, block_k=bk,
                                    interpret=True)
        np.testing.assert_allclose(got, _f32(want), rtol=2e-5, atol=2e-5)


def test_flash_attention_reads_strided_views():
    """(B, S, H, D) activations passed as transposed views give the same
    result as contiguous (B, H, S, D) copies (the model's layout)."""
    g = torch.Generator().manual_seed(3)
    q = torch.randn((2, 40, 4, 32), generator=g)
    k = torch.randn((2, 40, 2, 32), generator=g)
    v = torch.randn((2, 40, 2, 32), generator=g)
    views = [t.transpose(1, 2) for t in (q, k, v)]
    got = ops.flash_attention(*views, window=16, softcap=50.0)
    want = ref.flash_attention_ref(*[t.contiguous() for t in views],
                                   window=16, softcap=50.0)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------ weighted_agg

@pytest.mark.parametrize("C,P", [(2, 64), (16, 1000), (8, 4096), (5, 17)])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_weighted_agg_matches_pallas_kernel(C, P, dt):
    g = np.random.default_rng([C, P])
    s = g.standard_normal((C, P)).astype(np.float32)
    w = g.uniform(size=(C,)).astype(np.float32)
    ts = torch.from_numpy(s).to(getattr(torch, dt))
    got = ops.weighted_agg(ts, torch.from_numpy(w))
    assert got.dtype == ts.dtype and got.shape == (P,)
    js = jnp.asarray(s).astype(dt)
    tol = 1e-5 if dt == "float32" else 3e-2
    for want in (jops.weighted_agg(js, jnp.asarray(w), interpret=True),
                 jref.weighted_agg_ref(js, jnp.asarray(w))):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def test_weighted_agg_tree_matches_pallas_kernel():
    g = np.random.default_rng(0)
    tree = {"a": g.standard_normal((4, 3, 5)).astype(np.float32),
            "b": {"c": g.standard_normal((4, 7)).astype(np.float32)}}
    w = np.asarray([0.1, 0.2, 0.3, 0.4], np.float32)
    got = ops.weighted_agg_tree(
        {"a": torch.from_numpy(tree["a"]),
         "b": {"c": torch.from_numpy(tree["b"]["c"])}}, torch.from_numpy(w))
    want = jops.weighted_agg_tree(
        {"a": jnp.asarray(tree["a"]), "b": {"c": jnp.asarray(tree["b"]["c"])}},
        jnp.asarray(w), interpret=True)
    assert got["a"].shape == (3, 5) and got["b"]["c"].shape == (7,)
    np.testing.assert_allclose(got["a"].numpy(), np.asarray(want["a"]),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got["b"]["c"].numpy(),
                               np.asarray(want["b"]["c"]), rtol=2e-5,
                               atol=2e-5)


# --------------------------------------------------------------- dispatch

def test_cpu_flash_and_weighted_agg_count_nothing():
    ops.reset_launches()
    ops.flash_attention(torch.ones((1, 2, 3, 4)), torch.ones((1, 1, 3, 4)),
                        torch.ones((1, 1, 3, 4)))
    ops.weighted_agg(torch.ones((3, 5)), torch.ones((3,)))
    ops.weighted_agg_tree({"x": torch.ones((3, 2, 2))}, torch.ones((3,)))
    assert set(ops.LAUNCHES.values()) == {0}


def test_flash_attention_on_non_cpu_tensors_never_takes_the_plain_path():
    """A tensor that is not on the CPU must launch the kernel or raise:
    here a meta tensor is refused by the launcher's device check, and the
    plain version (which would run on meta tensors) is never reached."""
    ops.reset_launches()
    meta = torch.device("meta")
    q = torch.empty((1, 2, 8, 32), device=meta)
    kv = torch.empty((1, 1, 8, 32), device=meta)
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, kv, kv)
    with pytest.raises(ValueError, match="CUDA"):
        ops.weighted_agg(torch.empty((3, 5), device=meta),
                         torch.empty((3,), device=meta))
    assert set(ops.LAUNCHES.values()) == {0}


def test_flash_attention_off_the_cpu_refuses_to_be_differentiated():
    """The kernel is forward only: a call autograd would differentiate
    raises instead of returning an output without a gradient, while the
    CPU's plain version differentiates as usual."""
    ops.reset_launches()
    meta = torch.device("meta")
    q = torch.empty((1, 2, 8, 32), device=meta, requires_grad=True)
    kv = torch.empty((1, 1, 8, 32), device=meta)
    with pytest.raises(NotImplementedError, match="queue 2, item e"):
        ops.flash_attention(q, kv, kv)
    with pytest.raises(NotImplementedError, match="queue 2, item e"):
        ops.flash_attention(kv.expand(1, 2, 8, 32), kv,
                            kv.clone().requires_grad_(True))
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, kv, kv)          # no autograd: to the launcher
    assert set(ops.LAUNCHES.values()) == {0}
    qc = torch.randn((1, 2, 8, 32), requires_grad=True)
    kc = torch.randn((1, 1, 8, 32))
    ops.flash_attention(qc, kc, kc).sum().backward()
    assert qc.grad is not None and torch.isfinite(qc.grad).all()


# ------------------------------------------------- the launch plan (no card)

def _chip_smoke():
    """chip_smoke.py's constants (the card's tolerances), loaded by path."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _contiguous_strides(b, h, s, d):
    return [h * s * d, s * d, d]


@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_plan_routes_by_dtype_and_fits_shared_memory(d):
    """bf16 goes to the tensor-core kernel, f32 to the CUDA-core one, and
    both fit a block's 232,448 bytes of shared memory at D = 64, 128, 256
    (gemma2-2b's layer shapes)."""
    qs, ks = (2, 8, 8192, d), (2, 4, 8192, d)
    st = _contiguous_strides(*qs) + _contiguous_strides(*ks) * 2
    tc = flash.plan(qs, ks, torch.bfloat16, st, [0, 256, 512])
    assert tc.route == flash.TENSOR_CORES and tc.refused is None
    assert (tc.block_q, tc.block_k, tc.threads) == (128, 64, 384)
    assert tc.grid == (64, 8, 2) and 2 <= tc.stages <= 4
    assert tc.smem_bytes <= flash.SMEM_MAX == 232_448
    # one more stage would not fit (or the ring is at its cap of 4)
    assert tc.stages == 4 or (flash._sm90_smem(d, tc.stages + 1)
                              > flash.SMEM_MAX)
    cc = flash.plan(qs, ks, torch.float32, st, [0, 256, 512])
    assert cc.route == flash.CUDA_CORES and cc.refused is None
    assert cc.grid == (128, 8, 2) and cc.smem_bytes <= flash.SMEM_MAX
    if d == 256:                        # the f32 kernel's 217 KB
        assert cc.smem_bytes == 217_088


@pytest.mark.parametrize("what", ["pointer", "stride", "head_dim"])
def test_flash_plan_refuses_misaligned_bf16_and_never_reroutes(what):
    """A bf16 input TMA cannot read keeps the tensor-core route with the
    reason it is refused (the launcher raises ValueError with it); it is
    never handed to the CUDA-core kernel.  f32 takes any such input."""
    d = 40 if what == "head_dim" else 64
    qs, ks = (1, 4, 300, d), (1, 2, 300, d)
    st = _contiguous_strides(*qs) + _contiguous_strides(*ks) * 2
    ptrs = [0, 1024, 2048]
    if what == "pointer":
        ptrs[1] += 2                    # k one bf16 element off: a view
    if what == "stride":
        st[2] = d + 4                   # q rows 8 bytes past 16-byte steps
    pl = flash.plan(qs, ks, torch.bfloat16, st, ptrs)
    assert pl.route == flash.TENSOR_CORES
    assert pl.refused and {"pointer": "base address", "stride": "strides",
                           "head_dim": "multiple of 16"}[what] in pl.refused
    assert flash.plan(qs, ks, torch.float32, st, ptrs).refused is None


def test_flash_plan_strides_of_size_one_dims_are_free():
    """A size-1 dimension is never stepped over, so its stride (free in
    PyTorch) is set to D before TMA sees it."""
    q = torch.empty((1, 2, 1, 64)).as_strided((1, 2, 1, 64), (3, 64, 5, 1))
    assert flash.tma_strides(q) == (64, 64, 64)
    st = list(flash.tma_strides(q)) * 3
    assert flash.plan(q.shape, (1, 1, 300, 64), torch.bfloat16, st,
                      [0, 0, 0]).refused is None


# ------------------------------------------ the tensor-core kernel's numerics

def _emulate_sm90(q, k, v, *, causal, window, softcap):
    """The arithmetic of csrc/flash_attention_sm90.cu in torch on the CPU:
    bf16 inputs, f32 scores, tanh(x) = 1 - 2 / (2^(2x log2 e) + 1), scores
    in log2 units after the cap, online softmax over 64-key tiles with the
    finite NEG_INF, P V as P_hi V + P_lo V with P split into two bf16
    parts, finalize acc / max(l, 1e-30), output in bf16.  q (B, Hq, Sq, D),
    k/v (B, Hkv, Sk, D)."""
    log2e = 1.4426950408889634
    d = q.shape[-1]
    sq, sk = q.shape[2], k.shape[2]
    g = q.shape[1] // k.shape[1]
    kk = k.float().repeat_interleave(g, 1)
    vv = v.float().repeat_interleave(g, 1)
    qf = q.float()
    scale = 1.0 / math.sqrt(d)
    q_pos = sk - sq + torch.arange(sq)[:, None]
    m = torch.full(qf.shape[:3], ref.NEG_INF)
    l = torch.zeros(qf.shape[:3])
    acc = torch.zeros(qf.shape)
    for k0 in range(0, sk, 64):
        s = qf @ kk[:, :, k0:k0 + 64].transpose(-1, -2)
        if softcap:
            cap_out = softcap * log2e
            e = torch.exp2(s * (2 * log2e * scale / softcap))
            s = cap_out - 2 * cap_out / (e + 1)
        else:
            s = s * (scale * log2e)
        k_pos = k0 + torch.arange(s.shape[-1])[None, :]
        ok = torch.ones_like(k_pos, dtype=torch.bool) & (k_pos < sk)
        if causal:
            ok = ok & (k_pos <= q_pos)
        if window:
            ok = ok & (k_pos > q_pos - window)
        s = torch.where(ok, s, torch.tensor(ref.NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        hi = p.bfloat16().float()
        lo = (p - hi).bfloat16().float()
        v_t = vv[:, :, k0:k0 + 64]
        acc = acc * alpha[..., None] + (hi @ v_t + lo @ v_t)
        m = m_new
    return (acc / l.clamp_min(1e-30)[..., None]).bfloat16()


@pytest.mark.parametrize("window", [0, 128])
@pytest.mark.parametrize("q_scale", [1.0, 64.0], ids=["plain", "near_cap"])
def test_tensor_core_numerics_stay_inside_the_layer_budget(window, q_scale):
    """The tensor-core kernel's rounding (P as two bf16 parts in P V, the
    exp2 form of tanh) against the reference's Pallas kernel in interpret
    mode, at gemma2's head width and cap (B = 1, Hq = 2, Hkv = 1, S = 512,
    D = 256, cap 50): inside chip_smoke.py's FLASH_LAYER_RTOL_BF16 / ATOL,
    with ordinary scores and with q scaled so that scores sit near the cap.
    (P rounded once to bf16 misses this budget: 8 to 195 of the 262,144
    outputs here, up to 0.0156 off.)"""
    cs = _chip_smoke()
    g = np.random.default_rng([512, window, int(q_scale)])
    arrs = [g.standard_normal(s).astype(np.float32)
            for s in ((1, 2, 512, 256), (1, 1, 512, 256), (1, 1, 512, 256))]
    arrs[0] *= q_scale                     # a power of two: exact in bf16
    jq, jk, jv = [jnp.asarray(a).astype("bfloat16") for a in arrs]
    tq, tk, tv = [torch.from_numpy(a).bfloat16() for a in arrs]
    got = _emulate_sm90(tq, tk, tv, causal=True, window=window, softcap=50.0)
    want = jops.flash_attention(jq, jk, jv, causal=True, window=window,
                                softcap=50.0, interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(want),
                               rtol=cs.FLASH_LAYER_RTOL_BF16,
                               atol=cs.FLASH_LAYER_ATOL_BF16)
    # and the emulation is the plain version's function, to bf16 rounding
    plain = ref.flash_attention_ref(tq, tk, tv, window=window, softcap=50.0)
    np.testing.assert_allclose(_f32(got), _f32(plain),
                               rtol=cs.FLASH_LAYER_RTOL_BF16,
                               atol=cs.FLASH_LAYER_ATOL_BF16)
