"""The port's encoder-decoder (whisper-large-v3) and vision front end
(pixtral-12b) against ``repro.models`` and ``repro.launch.steps``, on the
CPU, in float32, from the same inputs (numpy draws) and the reference's own
parameters carried across (``params_from_numpy``).

Tolerances, those of ``tests/test_torch_transformer.py`` for float32 (both
sides differ only in summation order and in the ulps of exp/tanh/sin):
- one attention layer (cross-attention in train, prefill and decode; the
  encoder's non-causal self-attention in train and prefill): 1e-5;
- whole stacks (``encode``, ``forward``'s logits, ``prefill_last`` and
  two ``decode_step`` logits, the bundles' functions): 1e-4; caches 1e-5;
- ``loss_fn``: rtol 1e-5; its gradient rtol 1e-5 and an atol of 1e-5 of
  the leaf's largest gradient (``tests/test_torch_train.py``'s bar);
- prefill + decode against a longer forward within the port: 1e-4
  (``tests/test_torch_serve.py``'s bar).

On the CPU, ``ops.flash_attention`` is the plain version, so the prefill and
decode routes run their arithmetic here; the CUDA kernel is held against it
at these shapes by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import configs as jconfigs
from repro.configs import shapes as jshapes
from repro.launch import steps as jsteps
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro.models import transformer as jT
from repro_torch import configs as tconfigs
from repro_torch.configs import shapes as tshapes
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.launch import steps as tsteps
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.models import transformer as tT
from repro_torch.models.transformer import params_from_numpy
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

from test_torch_mesh import FakeMesh
from test_torch_steps import (_close_caches, _flat, _same_placements,
                              _same_specs)

torch.set_num_threads(1)        # see test_torch_jaxref.py
CPU = torch.device("cpu")
ARCHS = ("whisper-large-v3", "pixtral-12b")
B, S = 2, 40


def _cfgs(arch, **kw):
    j = jconfigs.smoke_variant(jconfigs.get_config(arch))
    t = tconfigs.smoke_variant(tconfigs.get_config(arch))
    if kw:
        j, t = jconfigs.base.replace(j, **kw), tconfigs.replace(t, **kw)
    return j, t


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _normal(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def _models(arch, seed=0, **kw):
    """Both configs, the reference's f32 parameters and the port's copy."""
    jc, tc = _cfgs(arch, **kw)
    jp = jmodel.init_params(jc, jax.random.PRNGKey(seed), jnp.float32)
    return jc, tc, jp, params_from_numpy(_np(jp), CPU)


def _front(cfg, seed, b=B):
    """The front end's input of ``cfg``: 0.1 * normal frames or patches
    (B, frontend_len, d_model), keyed as the batch takes it."""
    name = "frames" if cfg.is_enc_dec else "patch_embeds"
    return name, _normal(seed, (b, cfg.frontend_len, cfg.d_model), 0.1)


def _batches(cfg, toks, front, **extra):
    """The same batch for both packages."""
    j = {"tokens": jnp.asarray(toks), **{k: jnp.asarray(v)
                                         for k, v in extra.items()}}
    t = {"tokens": torch.from_numpy(toks).long(),
         **{k: torch.from_numpy(np.array(v)) for k, v in extra.items()}}
    if front is not None:
        j[front[0]] = jnp.asarray(front[1])
        t[front[0]] = torch.from_numpy(front[1])
    return j, t


# --------------------------------------------------------------- attention

ROUTES = [("cross", "train"), ("cross", "prefill"), ("cross", "decode"),
          ("encoder", "train"), ("encoder", "prefill")]


@pytest.mark.parametrize("kv_heads", [4, 2])        # whisper 4/4, GQA 4/2
@pytest.mark.parametrize("layer,mode", ROUTES)
def test_attention_routes_match_reference(layer, mode, kv_heads):
    """Cross-attention over Sk = 100 source rows (not a multiple of the
    kernel's 64-key tile; no rope, no cache, no mask) with Sq = 40 queries,
    or one in decode; and the encoder's non-causal self-attention (rope on
    q and k) over 100 positions."""
    jc, tc = _cfgs("whisper-large-v3", num_kv_heads=kv_heads)
    cross = layer == "cross"
    p = _np(jattn.init_attention(jc, jax.random.PRNGKey(2), jnp.float32,
                                 cross=cross))
    jp, tp = jax.tree_util.tree_map(jnp.asarray, p), params_from_numpy(p, CPU)
    sq = 1 if mode == "decode" else (S if cross else 100)
    x = _normal(3, (B, sq, jc.d_model))
    pos = (np.asarray([S], np.int32) if mode == "decode"
           else np.arange(sq, dtype=np.int32))
    kw = {}
    if cross:
        src = _normal(4, (B, 100, jc.d_model))
        kw = dict(jax=dict(kv_x=jnp.asarray(src)),
                  torch=dict(kv_x=torch.from_numpy(src)))
    else:
        kw = dict(jax=dict(causal=False), torch=dict(causal=False))
    jy, jcache = jattn.apply_attention(jc, jp, jnp.asarray(x), kind="attn",
                                       mode=mode, positions=jnp.asarray(pos),
                                       **kw["jax"])
    ty, tcache = tattn.apply_attention(tc, tp, torch.from_numpy(x),
                                       kind="attn", mode=mode,
                                       positions=torch.from_numpy(pos),
                                       **kw["torch"])
    assert jcache is None and tcache is None
    assert ty.shape == (B, sq, jc.d_model)
    _close(ty, jy, 1e-5)


# ------------------------------------------------------------- parameters

@pytest.mark.parametrize("arch,kw", [("whisper-large-v3", {}),
                                     ("whisper-large-v3", {"qkv_bias": True}),
                                     ("whisper-large-v3", {"num_layers": 3}),
                                     ("pixtral-12b", {})])
def test_init_params_tree_matches_reference(arch, kw):
    """Keys, nesting (tuples where the reference has tuples), shapes and
    dtypes: the encoder's stacked blocks, ``enc_pos`` and the decoder's
    cross blocks (whisper; under ``qkv_bias`` self-attention has biases
    and cross-attention none), ``proj`` (pixtral)."""
    jc, tc = _cfgs(arch, **kw)
    want = jax.eval_shape(lambda: jmodel.init_params(
        jc, jax.random.PRNGKey(0), jnp.float32))
    got = tmodel.init_params(tc, torch.Generator().manual_seed(0))
    g, w = _flat(got), _flat(want)
    assert set(g) == set(w)
    for k, x in g.items():
        assert tuple(x.shape) == tuple(w[k].shape), k
        assert str(x.dtype)[6:] == str(w[k].dtype), k
    assert isinstance(got["layers"], tuple)
    assert isinstance(got["rem_layers"], tuple)
    if jc.is_enc_dec:
        assert isinstance(got["encoder"]["layers"], tuple)
        assert "cross" in got["layers"][0] and "cross" not in \
            got["encoder"]["layers"][0]
        assert all("cross" in lp for lp in got["rem_layers"])
    # the initial scales: enc_pos 0.02, proj d_model^-0.5
    for name, scale in (("enc_pos", 0.02), ("proj", jc.d_model ** -0.5)):
        if name in got:
            assert abs(float(got[name].std()) / scale - 1) < 0.05


@pytest.mark.parametrize("arch,n_params", [("whisper-large-v3", 1.956e9),
                                           ("pixtral-12b", 1.160e10)])
def test_full_config_parameter_count_matches_reference(arch, n_params):
    """The full configs as meta tensors (nothing allocated) against the
    reference's ``jax.eval_shape(init_params)``, leaf for leaf, in bf16."""
    tcfg = tconfigs.get_config(arch)
    got = tsteps._param_structs(tcfg)
    want = jax.eval_shape(lambda: jmodel.init_params(
        jconfigs.get_config(arch), jax.random.PRNGKey(0)))
    _same_specs(got, want)
    count = tmodel.param_count(got)
    assert count == sum(x.size for x in jax.tree_util.tree_leaves(want))
    assert abs(count / n_params - 1) < 1e-3


# ---------------------------------------------------------- encode/forward

@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_encode_matches_reference(mode):
    """Both routes of the port's encoder (chunked and flash) against the
    reference's encoder (which always runs its train route)."""
    jc, tc, jp, tp = _models("whisper-large-v3")
    _, frames = _front(jc, 5)
    want = jT.encode(jc, jp, jnp.asarray(frames))
    got = tT.encode(tc, tp, torch.from_numpy(frames), mode=mode)
    assert got.shape == (B, jc.frontend_len, jc.d_model)
    _close(got, want, 1e-4)


FORWARD = [("whisper-large-v3", "train", "frames"),
           ("whisper-large-v3", "prefill", "frames"),
           ("whisper-large-v3", "prefill", "enc_out"),
           ("pixtral-12b", "train", "patch_embeds"),
           ("pixtral-12b", "prefill", "patch_embeds")]


@pytest.mark.parametrize("arch,mode,given", FORWARD)
def test_forward_matches_reference(arch, mode, given):
    """Logits over every position: whisper from frames (encoded inside
    ``forward``, in the mode's route) or from a given ``enc_out`` (the
    reference's encoder output, as serving hands it over); pixtral's
    projected patches in front of the text (frontend_len + S positions)."""
    jc, tc, jp, tp = _models(arch, 1)
    toks = _tokens(6, (B, S), jc.vocab_size)
    front = _front(jc, 7)
    if given == "enc_out":
        enc = np.asarray(jT.encode(jc, jp, jnp.asarray(front[1])))
        jb, tb = _batches(jc, toks, None, enc_out=enc)
    else:
        jb, tb = _batches(jc, toks, front)
    want, _, _ = jT.forward(jc, jp, jb, mode=mode)
    with torch.inference_mode():
        got, _, aux = tT.forward(tc, tp, tb, mode=mode)
    n = S + (jc.frontend_len if jc.frontend == "vision" else 0)
    assert got.shape == (B, n, jc.vocab_padded) and float(aux) == 0.0
    _close(got, want, 1e-4)


# ---------------------------------------------------------- prefill/decode

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """``prefill_last`` then two ``decode_step``s in both packages on the
    reference's parameters, the greedy tokens the reference's; the caches
    of a vision prompt hold frontend_len + S + 4 positions and the decode
    positions count the patches; whisper's decode steps take each
    package's own encoder output (the port's from its flash route)."""
    jc, tc, jp, tp = _models(arch, 2)
    toks = _tokens(8, (B, S), jc.vocab_size)
    front = _front(jc, 9)
    off = jc.frontend_len if jc.frontend == "vision" else 0
    max_len = off + S + 4
    jb, tb = _batches(jc, toks, front)
    jl, jcaches = jmodel.prefill_last(jc, jp, jb, max_len)
    with torch.inference_mode():
        tl, tcaches = tmodel.prefill_last(tc, tp, tb, max_len)
        t_enc = (tT.encode(tc, tp, tb["frames"], mode="prefill")
                 if jc.is_enc_dec else None)
    j_enc = jT.encode(jc, jp, jb["frames"]) if jc.is_enc_dec else None
    _close(tl, jl, 1e-4)
    assert tcaches["layers"][0]["k"].shape[2] == max_len
    for step in range(3):
        _close_caches(tcaches, _np(jcaches), 1e-5)
        if step == 2:
            break
        tok = np.array(jnp.argmax(jl.reshape(B, -1), -1), np.int32)[:, None]
        pos = off + S + step
        jl, jcaches = jmodel.decode_step(jc, jp, jcaches, jnp.asarray(tok),
                                         jnp.int32(pos), enc_out=j_enc)
        with torch.inference_mode():
            tl, tcaches = tmodel.decode_step(tc, tp, tcaches,
                                             torch.from_numpy(tok).long(),
                                             pos, enc_out=t_enc)
        _close(tl, jl, 1e-4)


@torch.inference_mode()
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_full_forward(arch):
    """The reference's ``tests/test_decode_consistency.py`` on the port,
    for both models: prefill then two decode steps, each equal to the
    full forward at the next position.  pixtral's prompt is 32 patches
    then the text, so decode step i runs at position 32 + S + i: a
    position that forgot the patches would rope the token and pick its
    cache slot wrongly, and miss the forward."""
    cfg = tconfigs.smoke_variant(tconfigs.get_config(arch))
    gen = torch.Generator().manual_seed(3)
    params = tmodel.init_params(cfg, gen)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    front = 0.1 * torch.randn((B, cfg.frontend_len, cfg.d_model),
                              generator=gen)
    batch, enc_out, off = {"tokens": toks}, None, 0
    if cfg.is_enc_dec:
        enc_out = tT.encode(cfg, params, front, mode="prefill")
        batch["enc_out"] = enc_out
    else:
        batch["patch_embeds"] = front
        off = cfg.frontend_len
    logits, caches = tmodel.prefill(cfg, params, batch, max_len=off + S + 4)
    assert logits.shape[1] == off + S
    seq = toks
    nxt = logits[:, -1:].argmax(-1)
    for step in range(2):
        dec, caches = tmodel.decode_step(cfg, params, caches, nxt,
                                         off + S + step, enc_out=enc_out)
        seq = torch.cat([seq, nxt], 1)
        full, _, _ = tT.forward(cfg, params, {**batch, "tokens": seq},
                                mode="train")
        torch.testing.assert_close(dec[:, 0], full[:, -1], rtol=1e-4,
                                   atol=1e-4)
        nxt = dec[:, -1:].argmax(-1)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_batch_tokens_are_the_forward_greedy_tokens(arch):
    """``serve_batch`` with frames or patches: its greedy tokens equal
    those of the full forward over the growing sequence, so the encode,
    the decode positions and the caches' length are the right ones."""
    cfg = tconfigs.smoke_variant(tconfigs.get_config(arch))
    gen = torch.Generator().manual_seed(4)
    params = tmodel.init_params(cfg, gen)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    front = 0.1 * torch.randn((B, cfg.frontend_len, cfg.d_model),
                              generator=gen)
    name = "frames" if cfg.is_enc_dec else "patch_embeds"
    res = serve.serve_batch(cfg, params, toks, 4, device="cpu",
                            **{name: front})
    assert res.tokens.shape == (B, 4)
    assert (res.encode_s > 0) == cfg.is_enc_dec
    n_pos = S + 4 + (cfg.frontend_len if name == "patch_embeds" else 0)
    per_pos = 2 * cfg.num_layers * cfg.num_kv_heads * cfg.head_dim * 4
    assert res.cache_bytes == cfg.num_layers * n_pos * 4 + B * n_pos * per_pos
    seq = toks
    with torch.inference_mode():
        for i in range(4):
            logits, _, _ = tT.forward(cfg, params,
                                      {"tokens": seq, name: front},
                                      mode="train")
            nxt = logits[:, -1].argmax(-1)[:, None]
            assert torch.equal(nxt[:, 0], res.tokens[:, i]), i
            seq = torch.cat([seq, nxt], 1)
    with pytest.raises(ValueError, match="needs frames|takes no frames"):
        serve.serve_batch(cfg, params, toks, 2, device="cpu",
                          **({"patch_embeds": front} if cfg.is_enc_dec
                             else {"frames": front}))


# --------------------------------------------------------------- training

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_value_and_gradients_match_reference(arch):
    """CE over the text positions only where patches lead the sequence;
    whisper's gradient reaches the encoder and ``enc_pos`` through its
    train route."""
    jc, tc, jp, _ = _models(arch, 3)
    toks = _tokens(10, (B, S + 1), jc.vocab_size)
    front = _front(jc, 11)
    jb, tb = _batches(jc, toks[:, :-1], front)
    jb["labels"], tb["labels"] = (jnp.asarray(toks[:, 1:]),
                                  torch.from_numpy(toks[:, 1:]).long())
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss_fn(jc, p, jb), has_aux=True))(jp)
    tp = params_from_numpy(_np(jp), CPU)
    leaves = [x.requires_grad_(True) for x in tree_leaves(tp)]
    tl, tm = tmodel.loss_fn(tc, tree_unflatten(tp, leaves), tb)
    grads = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tm["ce"].detach()), float(jm["ce"]),
                               rtol=1e-5)

    def one(g, w):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(
            g.float().numpy(), w, rtol=1e-5,
            atol=1e-5 * max(float(np.abs(w).max()), 1e-30))
    tree_map(one, tree_unflatten(tp, list(grads)), _np(jg))
    if jc.is_enc_dec:
        assert float(tree_unflatten(tp, list(grads))["enc_pos"].abs().max()) \
            > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_train_mode_never_calls_flash_attention(arch, monkeypatch):
    """``loss_fn`` and its backward with ``ops.flash_attention`` made to
    raise (with and without remat): whisper's encoder, self- and
    cross-attention and pixtral's layers all take the chunked route, which
    is what lets training run on the card (the kernel refuses autograd)."""
    def boom(*a, **k):
        raise AssertionError("train mode reached ops.flash_attention")
    monkeypatch.setattr(ops, "flash_attention", boom)
    cfg = tconfigs.smoke_variant(tconfigs.get_config(arch))
    p = tmodel.init_params(cfg, torch.Generator().manual_seed(0))
    leaves = [x.requires_grad_(True) for x in tree_leaves(p)]
    toks = torch.from_numpy(_tokens(12, (1, 17), cfg.vocab_size)).long()
    name, front = _front(cfg, 13, b=1)
    for remat in (False, True):
        loss, _ = tmodel.loss_fn(cfg, tree_unflatten(p, leaves),
                                 {"tokens": toks, "labels": toks,
                                  name: torch.from_numpy(front)},
                                 remat=remat)
        loss.backward()
    assert all(x.grad is not None for x in leaves)


def test_serving_routes_call_flash_attention(monkeypatch):
    """The other side: whisper's serving encode, prefill and decode step
    take ``ops.flash_attention`` exactly as often as the card run asserts
    (encoder layers; causal self plus cross a decoder layer; cross a
    decoder layer a step), non-causal but for the decoder's
    self-attention."""
    calls = []
    real = ops.flash_attention

    def counting(q, k, v, **kw):
        calls.append((q.shape[2], k.shape[2], kw["causal"]))
        return real(q, k, v, **kw)
    monkeypatch.setattr(ops, "flash_attention", counting)
    cfg = tconfigs.smoke_variant(tconfigs.get_config("whisper-large-v3"))
    gen = torch.Generator().manual_seed(5)
    params = tmodel.init_params(cfg, gen)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    frames = 0.1 * torch.randn((B, cfg.frontend_len, cfg.d_model),
                               generator=gen)
    F, n_enc, n_dec = cfg.frontend_len, cfg.encoder_layers, cfg.num_layers
    with torch.inference_mode():
        enc = tT.encode(cfg, params, frames, mode="prefill")
        assert calls == [(F, F, False)] * n_enc
        calls.clear()
        _, caches = tmodel.prefill_last(cfg, params,
                                        {"tokens": toks, "enc_out": enc},
                                        S + 2)
        assert calls == [(S, S, True), (S, F, False)] * n_dec
        calls.clear()
        tmodel.decode_step(cfg, params, caches, toks[:, :1], S, enc_out=enc)
        assert calls == [(1, F, False)] * n_dec


# ------------------------------------------------------------ step bundles

def _both(monkeypatch, arch):
    """The smoke variant and an f32 profile in both packages (the
    reference's builders read ``get_config``/``get_profile`` by arch)."""
    jcfg = jconfigs.smoke_variant(jconfigs.get_config(arch))
    jprof = dataclasses.replace(jconfigs.get_profile(arch),
                                param_dtype="float32")
    monkeypatch.setattr(jsteps, "get_config", lambda arch: jcfg)
    monkeypatch.setattr(jsteps, "get_profile", lambda arch: jprof)
    tcfg = tconfigs.smoke_variant(tconfigs.get_config(arch))
    tprof = dataclasses.replace(tconfigs.get_profile(arch),
                                param_dtype="float32")
    return jcfg, dict(cfg=tcfg, profile=tprof)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_serving_bundles_match_reference(arch, shape):
    """The full configs at the serving shapes that apply to them, as meta
    tensors: in_specs (prefill: tokens of S less frontend_len for pixtral,
    the frames or patches; decode: whisper's fifth input ``enc_out``),
    the caches, and every placement on a ("data", "model") mesh."""
    mesh = {"data": 2, "model": 4}
    jmesh = AbstractMesh(tuple(mesh.values()), tuple(mesh))
    tmesh = FakeMesh(mesh)
    jshape, tshape = jshapes.SHAPES[shape], tshapes.SHAPES[shape]
    assert tshapes.shape_applicable(tconfigs.get_config(arch), tshape) == (
        True, "")
    build_j = (jsteps.build_prefill_step if jshape.mode == "prefill"
               else jsteps.build_decode_step)
    build_t = (tsteps.build_prefill_step if tshape.mode == "prefill"
               else tsteps.build_decode_step)
    want, got = build_j(arch, jshape, jmesh), build_t(arch, tshape, tmesh)
    assert got.meta["batch_axes"] == want.meta["batch_axes"]
    assert len(got.in_specs) == len(want.in_specs) == len(got.in_shardings)
    for g, w in zip(got.in_specs, want.in_specs):
        _same_specs(g, w)
    for g, w in zip(got.in_shardings + (got.out_shardings,),
                    want.in_shardings + (want.out_shardings,)):
        _same_placements(g, w, tmesh)
    cfg = tconfigs.get_config(arch)
    if jshape.mode == "prefill":
        batch = got.in_specs[1]
        text = tshape.seq_len - (cfg.frontend_len
                                 if cfg.frontend == "vision" else 0)
        assert batch["tokens"].shape == (tshape.global_batch, text)
    elif cfg.is_enc_dec:
        assert got.in_specs[4].shape == (tshape.global_batch,
                                         cfg.frontend_len, cfg.d_model)
    meshless = build_t(arch, tshape, None)
    assert meshless.in_shardings == (None,) * len(got.in_specs)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_bundle_specs_match_reference(arch, monkeypatch):
    """``build_train_step``'s in_specs (the (C, ...) stack with the
    encoder or ``proj``, the (C, pcb, text) tokens and labels, the (C,
    pcb, frontend_len, d_model) frames or patches, the round index) equal
    the reference's on a 4-client mesh (clients over "data" for whisper,
    over "pod" for pixtral)."""
    _, kw = _both(monkeypatch, arch)
    axes = (("data", "model") if kw["profile"].client_axis == "data"
            else ("pod", "data", "model"))
    jmesh = AbstractMesh((4,) + (1,) * (len(axes) - 1), axes)
    shape = ("t", 64, 16, "train")
    got = tsteps.build_train_step(arch, tshapes.InputShape(*shape), None,
                                  num_clients=4, num_clusters=2, **kw)
    want = jsteps.build_train_step(arch, jshapes.InputShape(*shape), jmesh,
                                   num_clusters=2)
    assert (got.meta["pcb"], got.meta["accum"]) == (want.meta["pcb"],
                                                    want.meta["accum"])
    for g, w in zip(got.in_specs, want.in_specs):
        _same_specs(g, w)
    assert set(got.in_specs[1]) == {"tokens", "labels",
                                    _front(kw["cfg"], 0)[0]}


@pytest.mark.parametrize("arch", ARCHS)
def test_bundle_functions_match_reference(arch, monkeypatch):
    """The bundles' functions on the smoke variants: prefill over 80
    positions (pixtral's 32 patches and 48 tokens; whisper's frames
    encoded inside it), then two decode steps (whisper's with each
    package's encoder output as the fifth input) after a prefill two
    tokens shorter, against the reference's bundles: logits 1e-4, caches
    1e-5."""
    jcfg, kw = _both(monkeypatch, arch)
    seq = 80
    mesh = {"data": 2, "model": 4}
    jmesh = AbstractMesh(tuple(mesh.values()), tuple(mesh))
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(4), jnp.float32)
    tp = params_from_numpy(_np(jp), CPU)
    off = jcfg.frontend_len if jcfg.frontend == "vision" else 0
    toks = _tokens(14, (B, seq - off), jcfg.vocab_size)
    jb, tb = _batches(jcfg, toks, _front(jcfg, 15))
    jpre = jsteps.build_prefill_step(
        arch, jshapes.InputShape("p", seq, B, "prefill"), jmesh)
    tpre = tsteps.build_prefill_step(
        arch, tshapes.InputShape("p", seq, B, "prefill"), None, **kw)
    jl, jc = jpre.fn(jp, jb)
    with torch.inference_mode():
        tl, tc = tpre.fn(tp, tb)
    _close(tl, jl, 1e-4)
    _close_caches(tc, _np(jc), 1e-5)

    jdec = jsteps.build_decode_step(
        arch, jshapes.InputShape("d", seq, B, "decode"), jmesh)
    tdec = tsteps.build_decode_step(
        arch, tshapes.InputShape("d", seq, B, "decode"), None, **kw)
    n = seq - off - 2
    jb2, tb2 = dict(jb, tokens=jb["tokens"][:, :n]), dict(
        tb, tokens=tb["tokens"][:, :n])
    jl, jc = jmodel.prefill_last(jcfg, jp, jb2, seq)
    with torch.inference_mode():
        _, tc = tmodel.prefill_last(kw["cfg"], tp, tb2, seq)
        extra_t = ((tT.encode(kw["cfg"], tp, tb["frames"], mode="prefill"),)
                   if jcfg.is_enc_dec else ())
    extra_j = (jT.encode(jcfg, jp, jb["frames"]),) if jcfg.is_enc_dec else ()
    assert len(tdec.in_specs) == 4 + len(extra_t)
    tok = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
    for step in range(2):
        pos = off + n + step
        jl, jc = jdec.fn(jp, jc, jnp.asarray(tok), jnp.int32(pos), *extra_j)
        with torch.inference_mode():
            tl, tc = tdec.fn(tp, tc, torch.from_numpy(tok).long(), pos,
                             *extra_t)
        _close(tl, jl, 1e-4)
        tok = np.array(jnp.argmax(jl, -1), np.int32)[:, None]


def test_serve_batch_example_runs_on_cpu(capsys):
    """``examples/serve_batch_torch.py`` (the counterpart of
    ``examples/serve_batch.py``) on whisper's smoke variant: its encode,
    prefill and decode."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "examples" / \
        "serve_batch_torch.py"
    spec = importlib.util.spec_from_file_location("serve_batch_torch", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    example.main(["--arch", "whisper-large-v3", "--device", "cpu",
                            "--batch", "2", "--prompt-len", "8",
                            "--tokens", "3"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("prefill 2x8") and "device cpu" in out[0]
    assert len(out) == 5 and len(eval(out[3].strip())) == 3


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_runs_frontend_archs_on_cpu(arch, capsys):
    """``python -m repro_torch.launch.train --arch <front end> --smoke
    --device cpu``: the round's batch carries frames or patches (pixtral's
    tokens then fill the sequence less its 32 patches); two rounds (stage-2
    in the second), finite CE near ln V."""
    from repro_torch.launch import train as train_lib
    train_lib.main(["--arch", arch, "--smoke", "--device", "cpu",
                    "--rounds", "2", "--clients", "2", "--global-batch", "4"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["arch"] == arch + "-smoke" and out["dtype"] == "bfloat16"
    assert [r["did_global"] for r in out["rounds"]] == [False, True]
    assert all(abs(r["ce"] - out["ln_vocab"]) < 1.0 for r in out["rounds"])
