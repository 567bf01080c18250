"""The port's ``flash_attention`` and ``weighted_agg`` against the JAX
reference, on the CPU.

Here the dispatching wrappers (`repro_torch/kernels/ops.py`) take the plain
PyTorch versions; those are held against the interpreted Pallas kernels on
the sweeps of ``tests/test_kernels.py``, at its tolerances (flash 3e-5 in
f32 and 4e-2 in bf16; weighted_agg 1e-5 and 3e-2).  The CUDA kernels are
held against the plain versions in ``tests/test_torch_cuda.py`` (skipped
without a card) and by ``chip_smoke.py`` on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
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
    with pytest.raises(NotImplementedError, match="training slice"):
        ops.flash_attention(q, kv, kv)
    with pytest.raises(NotImplementedError, match="training slice"):
        ops.flash_attention(kv.expand(1, 2, 8, 32), kv,
                            kv.clone().requires_grad_(True))
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, kv, kv)          # no autograd: to the launcher
    assert set(ops.LAUNCHES.values()) == {0}
    qc = torch.randn((1, 2, 8, 32), requires_grad=True)
    kc = torch.randn((1, 1, 8, 32))
    ops.flash_attention(qc, kc, kc).sum().backward()
    assert qc.grad is not None and torch.isfinite(qc.grad).all()
