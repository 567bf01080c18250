"""The port's transformer serving slice against ``repro.models``, on the CPU,
from the same inputs and the reference's own parameters carried across
(``params_from_numpy``).

Tolerances, all stated against float32 computations on both sides, which
differ only in summation order and in the ulps of exp/tanh/sin:
- layers (norm, RoPE, MLP, embed, unembed): 1e-5;
- one attention layer, prefill and decode, output and caches: 1e-5
  (caches hold projections, so they agree to rounding);
- whole models, ``prefill_last`` and two ``decode_step`` logits: 1e-4 over
  two layers and a 512-way unembed; caches 1e-5;
- bfloat16 weights and activations: logits within 0.1 (about 3 bf16 ulps
  at the logits' scale), where the reference also rounds the attention
  probabilities to bf16 before P.V and the port keeps them in f32;
- the mixtures of experts (grok-1-314b, mixtral-8x22b) take their
  profile's dispatch (scan) and cache (grok: int8): the same bars, except
  that an int8 cache value may round one step apart where the layer's
  K/V (summed in other orders) land within an ulp of a half:
  ``test_torch_kv_int8.py``'s INT8_FLIPS per leaf, by 1 at most (1 of
  53,248 in grok-1's K after prefill).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from test_torch_kv_int8 import assert_int8_close
from repro.models import attention as jattn
from repro.models import layers as jL
from repro.models import model as jmodel
from repro_torch import configs as tconfigs
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tL
from repro_torch.models import model as tmodel
from repro_torch.models.transformer import params_from_numpy, params_to_numpy

torch.set_num_threads(1)        # see test_torch_jaxref.py
CPU = torch.device("cpu")


def _cfgs(arch, **kw):
    """The same smoke config in both packages, with overrides."""
    j = jconfigs.smoke_variant(jconfigs.get_config(arch))
    t = tconfigs.smoke_variant(tconfigs.get_config(arch))
    if kw:
        j, t = jconfigs.base.replace(j, **kw), tconfigs.replace(t, **kw)
    return j, t


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ------------------------------------------------------------------ layers

@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norm_matches(norm):
    jc, tc = _cfgs("gemma2-2b", norm=norm)
    x = _normal(0, (2, 5, jc.d_model))
    scale = 0.1 * _normal(1, (jc.d_model,))
    want = jL.apply_norm(jc, {"scale": jnp.asarray(scale)}, jnp.asarray(x))
    got = tL.apply_norm(tc, {"scale": torch.from_numpy(scale)},
                        torch.from_numpy(x))
    _close(got, want, 1e-5)


def test_rope_matches():
    jc, tc = _cfgs("qwen2-72b")          # rope_theta 1e6
    x = _normal(2, (2, 100, jc.num_heads, jc.head_dim))
    pos = np.arange(100, dtype=np.int32)
    js, jcos = jL.rope_frequencies(jc, jnp.asarray(pos))
    ts, tcos = tL.rope_frequencies(tc, torch.from_numpy(pos))
    _close(ts, js, 1e-5)
    _close(tcos, jcos, 1e-5)
    _close(tL.apply_rope(torch.from_numpy(x), ts, tcos),
           jL.apply_rope(jnp.asarray(x), js, jcos), 1e-5)


@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen2-72b"])   # gelu, silu
def test_mlp_matches(arch):
    jc, tc = _cfgs(arch)
    p = _np(jL.init_mlp(jc, jax.random.PRNGKey(0), jnp.float32))
    x = _normal(3, (2, 7, jc.d_model))
    _close(tL.apply_mlp(tc, params_from_numpy(p, CPU), torch.from_numpy(x)),
           jL.apply_mlp(jc, jax.tree_util.tree_map(jnp.asarray, p),
                        jnp.asarray(x)), 1e-5)


@pytest.mark.parametrize("arch", ["gemma2-2b", "h2o-danube-1.8b"])
def test_embed_and_unembed_match(arch):
    """gemma's sqrt(d_model) embed scale and final soft-cap, an untied
    unembed, and the pad mask (vocab 500 pads to 512)."""
    jc, tc = _cfgs(arch, vocab_size=500)
    p = _np(jL.init_embed(jc, jax.random.PRNGKey(1), jnp.float32))
    tp = params_from_numpy(p, CPU)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    toks = np.random.default_rng(4).integers(0, 500, (2, 9)).astype(np.int32)
    _close(tL.embed_tokens(tc, tp, torch.from_numpy(toks).long()),
           jL.embed_tokens(jc, jp, jnp.asarray(toks)), 1e-5)
    x = _normal(5, (2, 9, jc.d_model))
    got = tL.unembed(tc, tp, torch.from_numpy(x))
    want = jL.unembed(jc, jp, jnp.asarray(x))
    _close(got, want, 1e-5)
    assert got.shape[-1] == 512 and bool((got[..., 500:] == -1e30).all())


# --------------------------------------------------------------- attention

@pytest.mark.parametrize("kind", ["local", "global"])
@pytest.mark.parametrize("kv_heads", [4, 2])           # smoke 4/4, GQA 4/2
def test_attention_prefill_and_decode_match(kind, kv_heads):
    """One gemma2 attention layer (soft-cap 50, window 64) over S = 100 >
    window: prefill output and caches (the ring roll for local), then two
    decode steps, the second wrapping the ring."""
    jc, tc = _cfgs("gemma2-2b", num_kv_heads=kv_heads)
    B, S, max_len = 2, 100, 104
    p = _np(jattn.init_attention(jc, jax.random.PRNGKey(2), jnp.float32))
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    tp = params_from_numpy(p, CPU)
    x = _normal(6, (B, S, jc.d_model))
    jcache = jattn.init_cache(jc, kind, B, max_len, jnp.float32)
    tcache = tattn.init_cache(tc, kind, B, max_len, torch.float32, CPU)
    pos = np.arange(S, dtype=np.int32)
    jy, jcache = jattn.apply_attention(jc, jp, jnp.asarray(x), kind=kind,
                                       mode="prefill",
                                       positions=jnp.asarray(pos),
                                       cache=jcache)
    ty, tcache = tattn.apply_attention(tc, tp, torch.from_numpy(x),
                                       kind=kind, mode="prefill",
                                       positions=torch.from_numpy(pos),
                                       cache=tcache)
    _close(ty, jy, 1e-5)
    for key in ("k", "v", "slot_pos"):
        _close(tcache[key], jcache[key], 1e-5)
    for step in range(2):
        xd = _normal(7 + step, (B, 1, jc.d_model))
        p1 = np.asarray([S + step], np.int32)
        jy, jcache = jattn.apply_attention(jc, jp, jnp.asarray(xd), kind=kind,
                                           mode="decode",
                                           positions=jnp.asarray(p1),
                                           cache=jcache)
        ty, tcache = tattn.apply_attention(tc, tp, torch.from_numpy(xd),
                                           kind=kind, mode="decode",
                                           positions=torch.from_numpy(p1),
                                           cache=tcache)
        _close(ty, jy, 1e-5)
        for key in ("k", "v", "slot_pos"):
            _close(tcache[key], jcache[key], 1e-5)


# ------------------------------------------------------------------- model

def _assert_caches_close(tcaches, jcaches, tol, h_atol_frac=None):
    """Leaf by leaf at ``tol``; with ``h_atol_frac``, a recurrent state
    "h" at rtol ``tol`` and an atol of that fraction of its largest
    magnitude."""
    got = params_to_numpy(tcaches)
    want = _np(jcaches)
    assert len(got["layers"]) == len(want["layers"])
    assert len(got["rem_layers"]) == len(want["rem_layers"])
    for g, w in zip(got["layers"] + got["rem_layers"],
                    want["layers"] + want["rem_layers"]):
        assert set(g) == set(w)
        for key in g:
            if g[key].dtype == np.int8:
                assert_int8_close(g[key], w[key], what=key)
                continue
            want = np.asarray(w[key], np.float32)
            atol = tol
            if key == "h" and h_atol_frac is not None:
                atol = h_atol_frac * float(np.abs(want).max())
            np.testing.assert_allclose(g[key], want, rtol=tol, atol=atol)


def _serve_both(jc, tc, dtype, tol_logits, tol_cache, B=2, S=100,
                h_atol_frac=None):
    """prefill_last then two decode steps in both packages, on the
    reference's parameters; the greedy tokens are the reference's.  A
    mixture of experts takes its profile's dispatch and KV cache."""
    serve = {}
    if jc.num_experts:
        prof = jconfigs.get_profile(jc.name[:-len("-smoke")])
        serve = dict(dispatch=prof.moe_dispatch,
                     quantized_cache=prof.kv_int8)
    dispatch = serve.get("dispatch", "dense")
    jparams = jmodel.init_params(jc, jax.random.PRNGKey(0), dtype)
    tparams = params_from_numpy(_np(jparams), CPU)
    toks = np.random.default_rng(8).integers(0, jc.vocab_size, (B, S)
                                             ).astype(np.int32)
    max_len = S + 4
    jl, jcaches = jmodel.prefill_last(jc, jparams, {"tokens": jnp.asarray(toks)},
                                      max_len, **serve)
    with torch.inference_mode():
        tl, tcaches = tmodel.prefill_last(
            tc, tparams, {"tokens": torch.from_numpy(toks).long()}, max_len,
            **serve)
    assert tl.shape == (B, jc.vocab_padded) and tl.dtype == tparams[
        "embed"]["embedding"].dtype
    _close(tl, jl, tol_logits)
    _assert_caches_close(tcaches, jcaches, tol_cache, h_atol_frac)
    tok = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
    for step in range(2):
        jl, jcaches = jmodel.decode_step(jc, jparams, jcaches,
                                         jnp.asarray(tok), jnp.int32(S + step),
                                         dispatch=dispatch)
        with torch.inference_mode():
            tl, tcaches = tmodel.decode_step(
                tc, tparams, tcaches, torch.from_numpy(tok).long(), S + step,
                dispatch=dispatch)
        _close(tl, jl, tol_logits)
        tok = np.array(jnp.argmax(jl[:, 0], -1), np.int32)[:, None]
    _assert_caches_close(tcaches, jcaches, tol_cache, h_atol_frac)


@pytest.mark.parametrize("arch,kw", [
    ("gemma2-2b", {}),                       # local/global, both soft-caps
    ("gemma2-2b", {"num_kv_heads": 2}),      # the same with GQA 4/2
    ("h2o-danube-1.8b", {}),                 # SWA, untied unembed
    ("qwen2-72b", {}),                       # QKV bias, rope_theta 1e6
    ("mamba2-1.3b", {}),                     # SSD blocks, no MLP
    ("recurrentgemma-2b", {}),               # rglru, rglru, local (MQA)
    ("recurrentgemma-2b", {"num_layers": 5}),  # + two remainder rglru
    ("grok-1-314b", {}),                     # MoE (scan), int8 KV cache
    ("mixtral-8x22b", {"window_size": 32}),  # MoE (scan), SWA ring wraps
])
def test_model_prefill_and_decode_match_reference(arch, kw):
    jc, tc = _cfgs(arch, **kw)
    _serve_both(jc, tc, jnp.float32, 1e-4, 1e-5)


def test_model_bf16_matches_reference():
    """gemma2-2b smoke in bfloat16: the reference's bf16 leaves carried
    across through a 16-bit view."""
    jc, tc = _cfgs("gemma2-2b", num_kv_heads=2)
    _serve_both(jc, tc, jnp.bfloat16, 0.1, 0.05)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-2b"])
def test_recurrent_model_bf16_matches_reference(arch):
    """The recurrent smoke models in bfloat16, at gemma2's bars (logits
    0.1, bf16 caches 0.05).  The f32 recurrent states are sums over the
    prompt of products of bf16 activations, which the two packages may
    round one ulp (2^-8) apart: their atol is 2^-5 of the leaf's largest
    magnitude, the bar of ``test_torch_train.py``'s bf16 round."""
    jc, tc = _cfgs(arch)
    _serve_both(jc, tc, jnp.bfloat16, 0.1, 0.05, h_atol_frac=2.0 ** -5)


def test_params_carry_across_bf16_exactly():
    jc, _ = _cfgs("gemma2-2b")
    jparams = jmodel.init_params(jc, jax.random.PRNGKey(0), jnp.bfloat16)
    tparams = params_from_numpy(_np(jparams), CPU)
    assert tparams["embed"]["embedding"].dtype == torch.bfloat16
    got = params_to_numpy(tparams)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(_np(jparams))):
        np.testing.assert_array_equal(g, np.asarray(w, np.float32))
    assert tmodel.param_count(tparams) == jmodel.param_count(jparams)
