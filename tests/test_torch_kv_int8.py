"""The port's int8 KV cache (``models/attention.py``: ``init_cache(
quantized=True)``, ``_quantize_kv``, ``cache_from_prefill``,
``_cache_write_decode``, ``direct_attention`` with scales) against
``repro.models.attention``, on the CPU, in float32, from the same numpy
inputs.

Bars:
- ``_quantize_kv`` on the same input: int8 values equal (0 of the 512,000
  values of ``test_quantize_kv_matches_reference`` differ; both packages
  divide by the same f32 scale and round half to even), scales at rtol
  1e-6;
- cache writes (both branches of ``cache_from_prefill``, a decode write
  that wraps the ring) on the same K/V: int8 leaves equal, scales 1e-6;
- ``direct_attention`` on the same int8 cache and scales: 1e-5 against
  the reference, and the blocked contraction (a few slots a block)
  against the unblocked one at 1e-6;
- one grok-1 attention layer (smoke, GQA 4/4 and 4/2) through prefill and
  two decode steps, output 1e-5; its K/V come out of the layer's own
  projections, which the packages sum in other orders, so an int8 value
  may round one step apart where x / scale lands within an ulp of a
  half: at most INT8_FLIPS per cache leaf, none by more than 1.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro_torch import configs as tconfigs
from repro_torch.models import attention as tattn
from repro_torch.models.transformer import params_from_numpy

torch.set_num_threads(1)        # see test_torch_jaxref.py
CPU = torch.device("cpu")
INT8_FLIPS = 4


def _cfgs(**kw):
    j = jconfigs.smoke_variant(jconfigs.get_config("grok-1-314b"))
    t = tconfigs.smoke_variant(tconfigs.get_config("grok-1-314b"))
    if kw:
        j, t = jconfigs.base.replace(j, **kw), tconfigs.replace(t, **kw)
    return j, t


def _normal(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def assert_int8_close(got: np.ndarray, want, flips: int = INT8_FLIPS,
                      what: str = "") -> None:
    """int8 values equal but for at most ``flips``, each one step apart."""
    want = np.asarray(want)
    assert got.dtype == want.dtype == np.int8, what
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max(initial=0) <= 1 and int((d > 0).sum()) <= flips, \
        (what, int((d > 0).sum()))


def assert_cache_close(got: dict, want: dict, tol: float,
                       flips: int = 0) -> None:
    """One layer's cache leaf by leaf: int8 values at most ``flips``
    apart (each by one step), the rest at ``tol``."""
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key].detach()
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, key
        if g.dtype == torch.int8:
            assert_int8_close(g.numpy(), w, flips, key)
        else:
            np.testing.assert_allclose(g.float().numpy(),
                                       w.astype(np.float32), rtol=tol,
                                       atol=tol, err_msg=key)


def test_quantize_kv_matches_reference():
    for seed in range(5):
        x = _normal(seed, (2, 100, 4, 32), 2.0)
        x[0, 0, 0] = 0.0                         # amax 0: the 1e-6 floor
        jq, js = jattn._quantize_kv(jnp.asarray(x))
        tq, ts = tattn._quantize_kv(torch.from_numpy(x))
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
        assert int(tq.abs().max()) == 127


@pytest.mark.parametrize("kind", ["attn", "swa"])
def test_init_cache_quantized_matches_reference(kind):
    jc, tc = _cfgs(window_size=16)
    want = jattn.init_cache(jc, kind, 3, 40, jnp.float32, quantized=True)
    got = tattn.init_cache(tc, kind, 3, 40, torch.float32, CPU,
                           quantized=True, lead=(2,))
    assert set(got) == set(want)
    for key, w in want.items():
        assert tuple(got[key].shape) == (2,) + w.shape, key
        assert str(got[key].dtype)[6:] == str(w.dtype), key
        assert bool((got[key][1] == torch.from_numpy(np.array(w))).all())


@pytest.mark.parametrize("S,L", [(40, 48), (48, 48), (100, 32)])
def test_cache_from_prefill_matches_reference(S, L):
    """L >= S (a slice written at 0) and L < S (the ring's roll)."""
    jc, tc = _cfgs(window_size=L)
    k, v = (_normal(s, (2, S, jc.num_kv_heads, jc.head_dim)) for s in (1, 2))
    jcache = jattn.init_cache(jc, "swa", 2, 200, jnp.float32, quantized=True)
    tcache = tattn.init_cache(tc, "swa", 2, 200, torch.float32, CPU,
                              quantized=True)
    want = jattn.cache_from_prefill(jcache, jnp.asarray(k), jnp.asarray(v))
    got = tattn.cache_from_prefill(tcache, torch.from_numpy(k),
                                   torch.from_numpy(v))
    assert got is tcache                          # written in place
    assert_cache_close(got, want, 1e-6)


def test_cache_write_decode_matches_reference():
    """Three one-token writes into a 16-slot ring filled by a 20-token
    prefill: the second wraps to slot 5 % 16."""
    jc, tc = _cfgs(window_size=16)
    H, D = jc.num_kv_heads, jc.head_dim
    k, v = (_normal(s, (2, 20, H, D)) for s in (3, 4))
    jcache = jattn.cache_from_prefill(
        jattn.init_cache(jc, "swa", 2, 64, jnp.float32, quantized=True),
        jnp.asarray(k), jnp.asarray(v))
    tcache = tattn.cache_from_prefill(
        tattn.init_cache(tc, "swa", 2, 64, torch.float32, CPU,
                         quantized=True),
        torch.from_numpy(k), torch.from_numpy(v))
    for step in range(3):
        kn, vn = (_normal(10 + 2 * step + s, (2, 1, H, D)) for s in (0, 1))
        pos = 20 + step
        jcache = jattn._cache_write_decode(jcache, jnp.asarray(kn),
                                           jnp.asarray(vn), jnp.int32(pos))
        tattn._cache_write_decode(tcache, torch.from_numpy(kn),
                                  torch.from_numpy(vn),
                                  torch.tensor([pos], dtype=torch.int32))
        assert_cache_close(tcache, jcache, 1e-6)


@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("window", [0, 24])
def test_direct_attention_with_scales_matches_reference(quantized, window):
    """Decode attention over a 40-slot cache holding positions 0..33 (the
    rest empty), a gemma-style soft-cap on; blocks of 7 slots against one
    block and against the reference."""
    jc, tc = _cfgs(num_kv_heads=2, attn_softcap=30.0)
    B, L, H, D = 2, 40, jc.num_kv_heads, jc.head_dim
    q = _normal(5, (B, 1, jc.num_heads, D))
    k, v = (_normal(s, (B, L, H, D)) for s in (6, 7))
    kpos = np.where(np.arange(L) < 34, np.arange(L), -1).astype(np.int32)
    qpos = np.array([33], np.int32)
    if quantized:
        (k, ks), (v, vs) = (tuple(np.asarray(a) for a in
                                  jattn._quantize_kv(jnp.asarray(x)))
                            for x in (k, v))
    else:
        ks = vs = None
    want = jattn.direct_attention(
        jc, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(qpos), jnp.asarray(kpos), causal=True, window=window,
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs))
    t = {name: None if a is None else torch.from_numpy(a)
         for name, a in (("k_scale", ks), ("v_scale", vs))}
    outs = [tattn.direct_attention(
        tc, torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(qpos), torch.from_numpy(kpos), causal=True,
        window=window, block=block, **t) for block in (None, 7, L)]
    assert outs[0].dtype == torch.float32 and outs[0].shape == q.shape
    for out in outs:
        np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    torch.testing.assert_close(outs[1], outs[2], rtol=1e-6, atol=1e-6)


def test_decode_blocks_bound_the_float32_copy():
    """At grok-1's decode_32k shape (B 128, 32,768 slots, 8 kv heads of
    128) a block's float32 K is at most DECODE_BLOCK_BYTES: 512 slots, 64
    blocks; at B = 2 and 8,224 slots, one block."""
    assert tattn._slot_block(128, 32768, 8, 128) == 512
    assert 4 * 128 * 512 * 8 * 128 <= tattn.DECODE_BLOCK_BYTES
    assert tattn._slot_block(2, 8224, 8, 128) == 8224


@pytest.mark.parametrize("kind", ["attn", "swa"])
@pytest.mark.parametrize("kv_heads", [4, 2])
def test_int8_attention_layer_prefill_and_decode_match(kind, kv_heads):
    """One grok-1 attention layer with an int8 cache: prefill over S = 50
    (past the 32-slot window for "swa": the ring's roll) and two decode
    steps, output 1e-5, the cache's int8 values at most INT8_FLIPS apart,
    its scales 1e-5."""
    jc, tc = _cfgs(num_kv_heads=kv_heads, window_size=32)
    B, S, max_len = 2, 50, 54
    p = jax.tree_util.tree_map(
        np.asarray, jattn.init_attention(jc, jax.random.PRNGKey(2),
                                         jnp.float32))
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    tp = params_from_numpy(p, CPU)
    x = _normal(8, (B, S, jc.d_model))
    jcache = jattn.init_cache(jc, kind, B, max_len, jnp.float32,
                              quantized=True)
    tcache = tattn.init_cache(tc, kind, B, max_len, torch.float32, CPU,
                              quantized=True)
    pos = np.arange(S, dtype=np.int32)
    jy, jcache = jattn.apply_attention(jc, jp, jnp.asarray(x), kind=kind,
                                       mode="prefill",
                                       positions=jnp.asarray(pos),
                                       cache=jcache)
    ty, tcache = tattn.apply_attention(tc, tp, torch.from_numpy(x),
                                       kind=kind, mode="prefill",
                                       positions=torch.from_numpy(pos),
                                       cache=tcache)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    assert_cache_close(tcache, jcache, 1e-5, INT8_FLIPS)
    for step in range(2):
        xd = _normal(9 + step, (B, 1, jc.d_model))
        p1 = np.asarray([S + step], np.int32)
        jy, jcache = jattn.apply_attention(jc, jp, jnp.asarray(xd), kind=kind,
                                           mode="decode",
                                           positions=jnp.asarray(p1),
                                           cache=jcache)
        ty, tcache = tattn.apply_attention(tc, tp, torch.from_numpy(xd),
                                           kind=kind, mode="decode",
                                           positions=torch.from_numpy(p1),
                                           cache=tcache)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                                   atol=1e-5)
        assert_cache_close(tcache, jcache, 1e-5, INT8_FLIPS)
