"""The port's recurrent blocks (``models/ssm.py``, ``models/rglru.py``)
against ``repro.models.ssm`` and ``repro.models.rglru``, on the CPU, in
float32, from the same inputs: numpy draws and the reference's own
parameters carried across (``params_from_numpy``).

Tolerances, as ``test_torch_transformer.py``'s: both sides compute in
float32 and differ only in summation order (the chunked SSD's products,
the log-depth scan's tree against ``associative_scan``'s) and in the ulps
of exp:
- block outputs 1e-4 (rtol and atol), caches 1e-5;
- the chunked SSD and the scans against each other and the sequential
  oracles: 1e-5 relative, with an atol of 1e-5;
- ``loss_fn``'s value rtol 1e-5, its gradients rtol 1e-5 and an atol of
  1e-5 of the leaf's largest gradient (``test_torch_train.py``'s bar).

The smoke variants: mamba2 d_model 256, d_inner 512, 16 heads of 32,
state 32, chunk 32; recurrentgemma d_model 256, lru_width 256, window 64.
S = 100 is not a multiple of the chunk, so the padding path runs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as jmodel
from repro.models import rglru as jrglru
from repro.models import ssm as jssm
from repro_torch import configs as tconfigs
from repro_torch.models import model as tmodel
from repro_torch.models import rglru as trglru
from repro_torch.models import ssm as tssm
from repro_torch.models.transformer import params_from_numpy
from repro_torch.tree import tree_leaves, tree_unflatten

torch.set_num_threads(1)        # see test_torch_jaxref.py
CPU = torch.device("cpu")
ARCHS = ("mamba2-1.3b", "recurrentgemma-2b")


def _cfgs(arch):
    return (jconfigs.smoke_variant(jconfigs.get_config(arch)),
            tconfigs.smoke_variant(tconfigs.get_config(arch)))


def _normal(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _close(got, want, tol, atol=None):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol if atol is None else atol)


def _params(init, jc, seed):
    p = jax.tree_util.tree_map(np.asarray,
                               init(jc, jax.random.PRNGKey(seed), jnp.float32))
    return jax.tree_util.tree_map(jnp.asarray, p), params_from_numpy(p, CPU)


def _block_modes(japply, tapply, jc, tc, jp, tp, jcache, tcache, S, seed):
    """train, prefill into the cache, then two decode steps, in both
    packages: outputs at 1e-4, the caches at 1e-5 after each step."""
    B = 2
    x = _normal(seed, (B, S, jc.d_model))
    jy, _ = japply(jc, jp, jnp.asarray(x), mode="train")
    ty, none = tapply(tc, tp, torch.from_numpy(x), mode="train")
    assert none is None
    _close(ty, jy, 1e-4)
    jy, jcache = japply(jc, jp, jnp.asarray(x), mode="prefill", cache=jcache)
    ty, got = tapply(tc, tp, torch.from_numpy(x), mode="prefill",
                     cache=tcache)
    assert got is tcache                    # written in place
    _close(ty, jy, 1e-4)
    for key in jcache:
        _close(tcache[key], jcache[key], 1e-5)
    for step in range(2):
        xd = _normal(seed + 1 + step, (B, 1, jc.d_model))
        jy, jcache = japply(jc, jp, jnp.asarray(xd), mode="decode",
                            cache=jcache)
        ty, _ = tapply(tc, tp, torch.from_numpy(xd), mode="decode",
                       cache=tcache)
        _close(ty, jy, 1e-4)
        for key in jcache:
            assert tcache[key].dtype == getattr(torch, str(jcache[key].dtype))
            _close(tcache[key], jcache[key], 1e-5)


# --------------------------------------------------------------------- SSD

@pytest.mark.parametrize("S", [100, 1])
def test_apply_ssd_matches_reference(S):
    """train, prefill (state and conv caches) and two decode steps."""
    jc, tc = _cfgs("mamba2-1.3b")
    jp, tp = _params(jssm.init_ssd, jc, 0)
    # a spread of step sizes, so the decay matrix spans many scales
    jp = dict(jp, dt_bias=jnp.asarray(_normal(9, (jc.ssm_heads,))))
    tp = dict(tp, dt_bias=torch.from_numpy(np.array(jp["dt_bias"])))
    _block_modes(jssm.apply_ssd, tssm.apply_ssd, jc, tc, jp, tp,
                 jssm.init_ssd_cache(jc, 2, jnp.float32),
                 tssm.init_ssd_cache(tc, 2, torch.float32, CPU), S, 1)


@pytest.mark.parametrize("S", [100, 64, 1])
def test_ssd_chunked_matches_oracles(S):
    """The chunked SSD (y + D x, final state) against the port's and the
    reference's sequential oracles and the reference's chunked SSD."""
    jc, tc = _cfgs("mamba2-1.3b")
    B, H, P, N = 2, jc.ssm_heads, jc.ssm_head_dim, jc.ssm_state
    x = _normal(2, (B, S, H, P))
    dt = np.log1p(np.exp(_normal(3, (B, S, H)))).astype(np.float32)
    Bm, Cm = _normal(4, (B, S, N), 0.3), _normal(5, (B, S, N), 0.3)
    A = -np.linspace(1.0, 16.0, H).astype(np.float32) / 8
    D = _normal(6, (H,))
    j = [jnp.asarray(a) for a in (x, dt, Bm, Cm, A)]
    t = [torch.from_numpy(a) for a in (x, dt, Bm, Cm, A)]
    y, h = tssm._ssd_chunked(tc, *t)
    y = y + torch.from_numpy(D)[:, None] * t[0]
    jy, jh = jssm._ssd_chunked(jc, *j)
    jy = jy + jnp.asarray(D)[:, None] * j[0]
    oy, oh = jssm.ssd_reference(jc, *j, jnp.asarray(D))
    ty, th = tssm.ssd_reference(tc, *t, torch.from_numpy(D))
    for want_y, want_h in ((jy, jh), (oy, oh), (ty.numpy(), th.numpy())):
        _close(y, want_y, 1e-5)
        _close(h, want_h, 1e-5)
    _close(ty, oy, 1e-5)
    _close(th, oh, 1e-5)


# ------------------------------------------------------------------ RG-LRU

@pytest.mark.parametrize("S", [100, 1])
def test_apply_rglru_matches_reference(S):
    """train, prefill (state and conv caches) and two decode steps."""
    jc, tc = _cfgs("recurrentgemma-2b")
    jp, tp = _params(jrglru.init_rglru, jc, 1)
    _block_modes(jrglru.apply_rglru, trglru.apply_rglru, jc, tc, jp, tp,
                 jrglru.init_rglru_cache(jc, 2, jnp.float32),
                 trglru.init_rglru_cache(tc, 2, torch.float32, CPU), S, 7)


@pytest.mark.parametrize("S", [1, 7, 100, 1000])
def test_linear_scan_matches_associative_scan_and_oracles(S):
    """The log-depth scan against ``jax.lax.associative_scan`` of the
    reference's combine on the same (a, b), and on the block's own
    coefficients against both packages' sequential oracles."""
    a = np.random.default_rng(S).uniform(0.5, 1.0, (2, S, 64)).astype(
        np.float32)
    b = _normal(S + 1, (2, S, 64))

    def combine(e1, e2):
        return e1[0] * e2[0], e1[1] * e2[0] + e2[1]
    _, want = jax.lax.associative_scan(combine, (jnp.asarray(a),
                                                 jnp.asarray(b)), axis=1)
    got = trglru.linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    _close(got, want, 1e-5)

    jc, tc = _cfgs("recurrentgemma-2b")
    jp, tp = _params(jrglru.init_rglru, jc, 2)
    y = _normal(S + 2, (2, S, jc.lru_width))
    a_t, b_t = trglru._lru_coeffs(tp, torch.from_numpy(y))
    got = trglru.linear_scan(a_t, b_t)
    _close(got, jrglru.rglru_reference(jp, jnp.asarray(y)), 1e-5)
    _close(got, trglru.rglru_reference(tp, torch.from_numpy(y)), 1e-5)


def test_softplus_is_jax_softplus():
    """Above F.softplus's threshold of 20 too."""
    x = np.linspace(-40.0, 40.0, 801).astype(np.float32)
    _close(tssm.softplus(torch.from_numpy(x)),
           jax.nn.softplus(jnp.asarray(x)), 1e-6)


# ---------------------------------------------------------- whole models

def _shapes(tree, prefix=""):
    """{path: (shape, dtype)} of a tree of tensors."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple):
        items = enumerate(tree)
    else:
        return {prefix: (tuple(tree.shape), tree.dtype)}
    out = {}
    for k, v in items:
        out.update(_shapes(v, f"{prefix}/{k}"))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_reference(arch):
    """``ModelConfig.param_count`` of the full config, and the port's
    initialized smoke variant against the reference's parameter tree, path
    by path (shapes and dtypes)."""
    assert (tconfigs.get_config(arch).param_count()
            == jconfigs.get_config(arch).param_count())
    jc, tc = _cfgs(arch)
    jp = jmodel.init_params(jc, jax.random.PRNGKey(0), jnp.float32)
    tp = tmodel.init_params(tc, torch.Generator().manual_seed(0))
    carried = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), CPU)
    assert _shapes(tp) == _shapes(carried)
    assert tmodel.param_count(tp) == jmodel.param_count(jp)


def _close_tree(got, want, rtol, atol_frac):
    def one(g, w):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(
            g.detach().float().numpy(), w, rtol=rtol,
            atol=atol_frac * max(float(np.abs(w).max()), 1e-30))
    jax.tree_util.tree_map(one, got, want,
                           is_leaf=lambda x: isinstance(x, torch.Tensor))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_value_and_gradients_match_reference(arch):
    """``loss_fn`` and its gradient through both recurrent blocks (the
    SSD's chunked path and the RG-LRU's scan) against ``jax.value_and_grad``
    of the reference's."""
    jc, tc = _cfgs(arch)
    jp = jmodel.init_params(jc, jax.random.PRNGKey(3))
    toks = np.random.default_rng(1).integers(0, jc.vocab_size, (2, 41),
                                             dtype=np.int32)
    jb = {"tokens": jnp.asarray(toks[:, :-1]),
          "labels": jnp.asarray(toks[:, 1:])}
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jmodel.loss_fn(jc, p, jb), has_aux=True)(jp)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), CPU)
    leaves = [x.requires_grad_(True) for x in tree_leaves(tp)]
    tp = tree_unflatten(tp, leaves)
    tl, tm = tmodel.loss_fn(tc, tp, {"tokens": torch.from_numpy(toks[:, :-1]),
                                     "labels": torch.from_numpy(toks[:, 1:])})
    grads = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tm["ce"].detach()), float(jm["ce"]),
                               rtol=1e-5)
    assert float(tm["aux"]) == float(jm["aux"]) == 0.0
    _close_tree(tree_unflatten(tp, list(grads)),
                jax.tree_util.tree_map(np.asarray, jg), 1e-5, 1e-5)
