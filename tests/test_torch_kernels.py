"""The port's kernel modules against the JAX reference.

On the CPU the dispatching wrappers (`repro_torch/kernels/ops.py`) take the
plain PyTorch versions; those are held against ``repro/kernels/ref.py`` and
the interpreted Pallas kernels on the sweeps of ``tests/test_kernels.py``,
at its tolerances.  The CUDA kernels themselves are held against the plain
versions in ``tests/test_torch_cuda.py`` (skipped without a card) and by
``chip_smoke.py`` on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import build, ops
from repro_torch.kernels import weighted_agg as wagg_launcher


torch.set_num_threads(1)        # see test_torch_jaxref.py


def _rng(*key):
    return np.random.default_rng(list(key))


# ------------------------------------------------------ weighted_agg_multi

@pytest.mark.parametrize("C,P,K", [(4, 100, 2), (16, 3000, 5), (12, 2048, 8)])
def test_weighted_agg_multi_plain_matches_reference(C, P, K):
    """Plain version == the JAX einsum oracle == the interpreted Pallas
    kernel == K single-weight Pallas reductions (2e-5)."""
    g = _rng(C, P, K)
    s = g.standard_normal((C, P)).astype(np.float32)
    w = g.uniform(size=(C, K)).astype(np.float32)
    got = ops.weighted_agg_multi(torch.from_numpy(s),
                                 torch.from_numpy(w)).numpy()
    want = np.asarray(jref.weighted_agg_multi_ref(jnp.asarray(s),
                                                  jnp.asarray(w)))
    pallas = np.asarray(jops.weighted_agg_multi(jnp.asarray(s),
                                                jnp.asarray(w),
                                                interpret=True))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, pallas, rtol=2e-5, atol=2e-5)
    for k in range(K):
        one = np.asarray(jops.weighted_agg(jnp.asarray(s),
                                           jnp.asarray(w[:, k]),
                                           interpret=True))
        np.testing.assert_allclose(got[k], one, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("C,P", [(2, 64), (16, 1000), (8, 4096), (5, 17)])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_weighted_agg_multi_dtypes(C, P, dt):
    """f32 and bf16 stacks, f32 accumulation, output in the stack's dtype
    (the dtype sweep of tests/test_kernels.py, at its tolerances)."""
    g = _rng(C, P)
    s = g.standard_normal((C, P)).astype(np.float32)
    w = g.uniform(size=(C, 3)).astype(np.float32)
    ts = torch.from_numpy(s).to(getattr(torch, dt))
    got = ops.weighted_agg_multi(ts, torch.from_numpy(w))
    assert got.dtype == ts.dtype and got.shape == (3, P)
    want = jref.weighted_agg_multi_ref(jnp.asarray(s).astype(dt),
                                       jnp.asarray(w))
    tol = 1e-5 if dt == "float32" else 3e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_weighted_agg_multi_tree_is_leafwise():
    g = _rng(7)
    tree = {"a": {"w": torch.from_numpy(
                g.standard_normal((4, 3, 5)).astype(np.float32))},
            "b": torch.from_numpy(g.standard_normal((4, 7)).astype(np.float32))}
    w = torch.from_numpy(g.uniform(size=(4, 2)).astype(np.float32))
    got = ops.weighted_agg_multi_tree(tree, w)
    assert got["a"]["w"].shape == (2, 3, 5) and got["b"].shape == (2, 7)
    want = np.einsum("c...,ck->k...", tree["a"]["w"].numpy(), w.numpy())
    np.testing.assert_allclose(got["a"]["w"].numpy(), want, rtol=2e-5,
                               atol=2e-5)


# ----------------------------------------------------------- kmeans_assign

@pytest.mark.parametrize("N,D,K", [(100, 3, 4), (513, 10, 7), (64, 128, 16),
                                   (1000, 3, 5)])
def test_kmeans_assign_plain_matches_reference(N, D, K):
    """Exact assignment, and the min distance at tests/test_kernels.py's
    tolerance, against the JAX oracle and the interpreted Pallas kernel."""
    g = _rng(N, D, K)
    x = g.standard_normal((N, D)).astype(np.float32)
    c = g.standard_normal((K, D)).astype(np.float32)
    a, d = ops.kmeans_assign(torch.from_numpy(x), torch.from_numpy(c))
    assert a.dtype == torch.int32 and d.dtype == torch.float32
    for ja, jd in (jref.kmeans_assign_ref(jnp.asarray(x), jnp.asarray(c)),
                   jops.kmeans_assign(jnp.asarray(x), jnp.asarray(c),
                                      interpret=True)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-4,
                                   atol=1e-4)


def test_kmeans_assign_ties_take_first_index():
    x = torch.zeros((4, 3))
    c = torch.tensor([[1.0, 0, 0], [0, 1.0, 0], [1.0, 0, 0]])
    a, d = ops.kmeans_assign(x, c)
    assert a.tolist() == [0, 0, 0, 0]
    assert d.tolist() == [1.0] * 4


# --------------------------------------------------- dispatch and the build

def test_cpu_tensors_take_the_plain_path_and_count_nothing():
    ops.reset_launches()
    ops.weighted_agg_multi(torch.ones((3, 5)), torch.ones((3, 2)))
    ops.kmeans_assign(torch.ones((3, 3)), torch.ones((2, 3)))
    assert ops.LAUNCHES == {"weighted_agg_multi": 0, "kmeans_assign": 0}


def test_non_cpu_tensors_never_fall_back_to_the_plain_path():
    """A tensor that is not on the CPU must launch the kernel or raise:
    here a meta tensor is refused by the launcher's device check."""
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.weighted_agg_multi(torch.empty((3, 5), device=meta),
                               torch.empty((3, 2), device=meta))
    with pytest.raises(ValueError, match="CUDA"):
        ops.kmeans_assign(torch.empty((3, 3), device=meta),
                          torch.empty((2, 3), device=meta))
    assert ops.LAUNCHES == {"weighted_agg_multi": 0, "kmeans_assign": 0}


def test_build_without_nvcc_raises_a_clear_error(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(build, "DEFAULT_NVCC", tmp_path / "nvcc")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_LOADED", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load("weighted_agg")
    assert not (tmp_path / "build").exists()


@pytest.mark.parametrize("c,p,vec4,want", [
    (800, 30720, True, (4, 1)),      # LeNet f1.w: 240 column tiles
    (800, 10080, True, (4, 3)),      # f2.w: 79 tiles, split C in three
    (800, 6, False, (1, 12)),        # a bias: one tile, 12 splits of 67 rows
    (32, 150, False, (1, 1)),        # small C is never split
    (16, 3000, False, (1, 1)),
])
def test_weighted_agg_launch_plan(c, p, vec4, want):
    """About two blocks per SM of an H100 (132 SMs), at least 64 rows a
    block, every row covered once."""
    pl = wagg_launcher.plan(c, p, vec4=vec4, num_sms=132)
    assert tuple(pl) == want
    rows = -(-c // pl.splits)
    assert (pl.splits - 1) * rows < c <= pl.splits * rows


def test_every_source_is_built_under_a_content_hash():
    for name in build.SOURCES:
        assert (build.CSRC / f"{name}.cu").is_file()
        p = build._lib_path(name)
        assert p.parent == build.BUILD_DIR and p.name.startswith(f"lib{name}-")
