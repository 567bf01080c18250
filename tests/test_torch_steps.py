"""The port's step builders (``launch/steps.py``) and ``shape_applicable``
against the JAX package, on the CPU, in float32.

* ``build_prefill_step`` and ``build_decode_step`` on the smoke variant
  of gemma2-2b (local and global layers, so the caches differ in length)
  beside the reference's builders on an ``AbstractMesh`` of the same
  shape: ``in_specs`` (shapes and dtypes, leaf by leaf), ``meta``'s batch
  axes, and every in/out placement equal to the reference's
  ``NamedSharding`` spec as DTensor placements.  The meshes cover the
  batch over ("pod", "data"), its fall-backs (to "data" for prefill, to
  replicated for decode) and a "model" size that divides the global
  layers' cache length but not the local layers' (so ``cache_spec_tree``
  takes both branches).
* The bundles' functions on the reference's parameters: prefill's
  last-position logits and caches, then two decode steps after a shorter
  prefill, at 1e-4 (logits) and 1e-5 (caches), the bars of
  ``tests/test_torch_transformer.py``'s whole-model serving test; for
  gemma2-2b and for the recurrent families (mamba2-1.3b, recurrentgemma-2b),
  whose bundles' in_specs, cache structs and placements are also held at
  the full configs at ``prefill_32k``, ``decode_32k`` and ``long_500k``;
  and for the mixtures of experts (grok-1-314b with its int8 cache,
  mixtral-8x22b), with their profiles' scan dispatch, at the same bars
  (an int8 cache value at most ``test_torch_kv_int8.py``'s INT8_FLIPS
  apart), their full configs' bundles at the shapes that apply to them
  (``cache_spec_tree`` over the int8 cache's scales included).
* ``build_step`` routes by the shape's mode; ``build_train_step``'s
  ``in_specs`` equal the reference's on a 4-client mesh.
* ``shape_applicable`` equals the reference's for every arch and shape.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP
from torch.distributed.tensor import Placement

from repro import configs as jconfigs
from repro.configs import shapes as jshapes
from repro.launch import steps as jsteps
from repro.models import model as jmodel
from repro_torch import configs as tconfigs
from repro_torch.configs import shapes as tshapes
from repro_torch.launch import steps as tsteps
from repro_torch.models import model as tmodel
from repro_torch.models.transformer import params_from_numpy, params_to_numpy
from repro_torch.sharding import rules as trules

from test_torch_kv_int8 import assert_int8_close
from test_torch_mesh import FakeMesh

CPU = torch.device("cpu")
ARCH = "gemma2-2b"
SEQ = 80            # smoke variant: local caches 64 (the window), global 80


def _both(monkeypatch, arch=ARCH):
    """The smoke variant and an f32 profile, in both packages (the
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


def _is_leaf(x):
    """A spec (either package's) or a tuple of DTensor placements is a
    leaf."""
    if isinstance(x, (JP, trules.PartitionSpec)):
        return True
    return (isinstance(x, tuple) and len(x) > 0
            and all(isinstance(p, Placement) for p in x))


def _flat(tree, prefix=""):
    """{path: leaf} over dicts, tuples and lists, in both packages; a
    placement tuple or a PartitionSpec is a leaf."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (tuple, list)) and not _is_leaf(tree):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


def _same_specs(got, want):
    """Port meta tensors against the reference's ShapeDtypeStructs."""
    g, w = _flat(got), _flat(want)
    assert set(g) == set(w)
    for k, x in g.items():
        assert x.device.type == "meta", k
        assert tuple(x.shape) == tuple(w[k].shape), k
        assert str(x.dtype)[6:] == str(w[k].dtype), k


def _same_placements(got, want, mesh):
    """Port placements against the reference's NamedShardings."""
    g, w = _flat(got), _flat(want)
    assert set(g) == set(w)
    for k, pl in g.items():
        assert pl == trules.placements(trules.P(*w[k].spec), mesh), \
            (k, w[k].spec)


# (mesh, batch, prefill's batch axes, decode's, the caches' seq axes)
MESHES = [
    ({"data": 2, "model": 4}, 4, "data", "data", {"model"}),
    ({"pod": 2, "data": 2, "model": 4}, 4, ("pod", "data"), ("pod", "data"),
     {"model"}),
    ({"pod": 2, "data": 2, "model": 4}, 2, "data", None, {"model"}),
    ({"data": 2, "model": 5}, 2, "data", "data", {"model", None}),
]


@pytest.mark.parametrize("mesh_shape,batch,pre_axes,dec_axes,seq_axes",
                         MESHES)
def test_serving_bundles_specs_and_placements_match_reference(
        mesh_shape, batch, pre_axes, dec_axes, seq_axes, monkeypatch):
    _, kw = _both(monkeypatch)
    jmesh = AbstractMesh(tuple(mesh_shape.values()), tuple(mesh_shape))
    tmesh = FakeMesh(mesh_shape)
    for mode, build_j, build_t in (
            ("prefill", jsteps.build_prefill_step, tsteps.build_prefill_step),
            ("decode", jsteps.build_decode_step, tsteps.build_decode_step)):
        shape = jshapes.InputShape("s", SEQ, batch, mode)
        want = build_j(ARCH, shape, jmesh)
        got = build_t(ARCH, tshapes.InputShape("s", SEQ, batch, mode), tmesh,
                      **kw)
        assert got.meta["mode"] == want.meta["mode"] == mode
        assert got.meta["batch_axes"] == want.meta["batch_axes"] == (
            pre_axes if mode == "prefill" else dec_axes)
        assert len(got.in_specs) == len(want.in_specs)
        for g, w in zip(got.in_specs, want.in_specs):
            _same_specs(g, w)
        for g, w in zip(got.in_shardings, want.in_shardings):
            _same_placements(g, w, tmesh)
        for g, w in zip(got.out_shardings, want.out_shardings):
            _same_placements(g, w, tmesh)
        # the cache specs themselves, as PartitionSpecs
        caches = got.in_specs[1] if mode == "decode" else \
            tsteps._cache_structs(kw["cfg"], kw["profile"], batch, SEQ)
        jcaches = want.in_specs[1] if mode == "decode" else jax.eval_shape(
            lambda: jsteps.T.init_caches(jsteps.get_config(ARCH), batch,
                                         SEQ, jnp.float32))
        g = _flat(tsteps.cache_spec_tree(caches, got.meta["batch_axes"],
                                         tmesh))
        w = _flat(jsteps.cache_spec_tree(jcaches, want.meta["batch_axes"],
                                         jmesh))
        assert {k: JP(*s) for k, s in g.items()} == w
        assert {s[-1] for k, s in g.items() if k.endswith("/k")} == seq_axes
    # without a mesh there are no placements
    bundle = tsteps.build_prefill_step(
        ARCH, tshapes.InputShape("s", SEQ, batch, "prefill"), None, **kw)
    assert bundle.in_shardings == (None, None)
    assert bundle.meta["batch_axes"] is None


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _close_caches(got, want, tol):
    g, w = _flat(params_to_numpy(got)), _flat(want)
    assert set(g) == set(w)
    for k in g:
        if g[k].dtype == np.int8:
            assert_int8_close(g[k], w[k], what=k)
            continue
        np.testing.assert_allclose(g[k], np.asarray(w[k], np.float32),
                                   rtol=tol, atol=tol, err_msg=k)


def _bundle_functions_match(monkeypatch, arch, seed):
    """Prefill over SEQ tokens, then two decode steps after a prefill of
    SEQ - 2 tokens into caches of SEQ, through the bundles' functions of
    the smoke variant of ``arch``."""
    jcfg, kw = _both(monkeypatch, arch)
    mesh = {"data": 2, "model": 4}
    jmesh = AbstractMesh(tuple(mesh.values()), tuple(mesh))
    B = 2
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                CPU)
    toks = np.random.default_rng(seed + 1).integers(
        0, jcfg.vocab_size, (B, SEQ)).astype(np.int32)

    jpre = jsteps.build_prefill_step(
        arch, jshapes.InputShape("p", SEQ, B, "prefill"), jmesh)
    tpre = tsteps.build_prefill_step(
        arch, tshapes.InputShape("p", SEQ, B, "prefill"), None, **kw)
    jl, jc = jpre.fn(jparams, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        tl, tc = tpre.fn(tparams, {"tokens": torch.from_numpy(toks).long()})
    assert tl.shape == (B, jcfg.vocab_padded)
    _close(tl, jl, 1e-4)
    _close_caches(tc, jc, 1e-5)

    jdec = jsteps.build_decode_step(
        arch, jshapes.InputShape("d", SEQ, B, "decode"), jmesh)
    tdec = tsteps.build_decode_step(
        arch, tshapes.InputShape("d", SEQ, B, "decode"), None, **kw)
    n = SEQ - 2
    prof = kw["profile"]
    serve = dict(dispatch=prof.moe_dispatch, quantized_cache=prof.kv_int8)
    jl, jc = jmodel.prefill_last(jcfg, jparams,
                                 {"tokens": jnp.asarray(toks[:, :n])}, SEQ,
                                 **serve)
    with torch.inference_mode():
        _, tc = tmodel.prefill_last(
            kw["cfg"], tparams, {"tokens": torch.from_numpy(toks[:, :n])
                                 .long()}, SEQ, **serve)
    tok = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
    for step in range(2):
        jl, jc = jdec.fn(jparams, jc, jnp.asarray(tok), jnp.int32(n + step))
        with torch.inference_mode():
            tl, tc = tdec.fn(tparams, tc, torch.from_numpy(tok).long(),
                             n + step)
        assert tl.shape == (B, jcfg.vocab_padded)
        _close(tl, jl, 1e-4)
        tok = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
    _close_caches(tc, jc, 1e-5)


def test_serving_bundle_functions_match_reference(monkeypatch):
    _bundle_functions_match(monkeypatch, ARCH, 4)


RECURRENT = ("mamba2-1.3b", "recurrentgemma-2b")


@pytest.mark.parametrize("arch", RECURRENT)
@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k", "long_500k"])
def test_recurrent_serving_bundles_match_reference(arch, shape):
    """The full configs at the published serving shapes (nothing is
    allocated: meta tensors against ``jax.eval_shape``): in_specs, the
    recurrent and ring caches' structs (recurrentgemma's local caches hold
    2048 slots at any length; mamba2's state does not depend on it), and
    every placement, on a ("data", "model") mesh: the reference's, but
    where the port's mesh program holds a rank's heads or channels of a
    recurrent layer (the reference lets GSPMD place the rest): the SSD's
    ``A_log``, ``D``, ``dt_bias`` and ``norm_scale`` and every recurrent
    cache over "model" too, the SSD's ``in_proj`` and conv cut part by
    part (the cuts beside the placements)."""
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
    for g, w in zip(got.in_specs, want.in_specs):
        _same_specs(g, w)
    own = {"/A_log": ("model",), "/D": ("model",), "/dt_bias": ("model",),
           "/norm_scale": ("model",), "/h": ("model",),
           "/conv": (None, "model")}
    cut = ("/in_proj", "/conv_w", "/conv_b", "/conv")
    for g, w in zip(got.in_shardings + (got.out_shardings,),
                    want.in_shardings + (want.out_shardings,)):
        g, w = _flat(g), _flat(w)
        assert set(g) == set(w)
        for k, pl in g.items():
            spec = tuple(w[k].spec)
            tail = [t for s, t in own.items() if k.endswith(s)]
            if k.endswith(("/h", "/conv")):      # a cache: after the batch
                spec += tail[0]
            elif tail:                           # a stacked SSD leaf
                spec = (None,) + tail[0]
            assert pl == trules.placements(trules.P(*spec), tmesh), \
                (k, spec, pl)
            ssd_cut = arch == "mamba2-1.3b" and k.endswith(cut)
            assert bool(getattr(pl, "cuts", ())) == ssd_cut, k
    cfg = tconfigs.get_config(arch)
    caches = tsteps._cache_structs(cfg, tconfigs.get_profile(arch),
                                   tshape.global_batch, tshape.seq_len)
    if arch == "recurrentgemma-2b":
        assert caches["layers"][2]["k"].shape == (
            8, tshape.global_batch, 2048, 1, 256)
        assert caches["layers"][0]["h"].shape == (8, tshape.global_batch,
                                                  2560)
    else:
        assert caches["layers"][0]["h"].shape == (
            48, tshape.global_batch, 64, 64, 128)
    assert all(set(c) == {"h", "conv"} for c in caches["rem_layers"])


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_bundle_functions_match_reference(arch, monkeypatch):
    """The recurrent smoke variants through the bundles' functions (the
    decode steps past recurrentgemma's 64-token window)."""
    _bundle_functions_match(monkeypatch, arch, 6)


MOE = ("grok-1-314b", "mixtral-8x22b")


@pytest.mark.parametrize("arch,shape", [
    ("grok-1-314b", "prefill_32k"), ("grok-1-314b", "decode_32k"),
    ("mixtral-8x22b", "prefill_32k"), ("mixtral-8x22b", "decode_32k"),
    ("mixtral-8x22b", "long_500k")])
def test_moe_serving_bundles_match_reference(arch, shape):
    """The full MoE configs at the serving shapes that apply to them
    (grok-1 is pure full attention: no ``long_500k``), as meta tensors:
    in_specs (the (E, d, f) expert stacks), grok-1's int8 cache with its
    f32 scales, and every placement on a ("data", "model") mesh."""
    mesh = {"data": 2, "model": 4}
    jmesh = AbstractMesh(tuple(mesh.values()), tuple(mesh))
    tmesh = FakeMesh(mesh)
    jshape, tshape = jshapes.SHAPES[shape], tshapes.SHAPES[shape]
    build_j = (jsteps.build_prefill_step if jshape.mode == "prefill"
               else jsteps.build_decode_step)
    build_t = (tsteps.build_prefill_step if tshape.mode == "prefill"
               else tsteps.build_decode_step)
    want, got = build_j(arch, jshape, jmesh), build_t(arch, tshape, tmesh)
    assert got.meta["batch_axes"] == want.meta["batch_axes"]
    for g, w in zip(got.in_specs, want.in_specs):
        _same_specs(g, w)
    for g, w in zip(got.in_shardings + (got.out_shardings,),
                    want.in_shardings + (want.out_shardings,)):
        _same_placements(g, w, tmesh)
    cfg, prof = tconfigs.get_config(arch), tconfigs.get_profile(arch)
    moe = got.in_specs[0]["layers"][0]["moe"]
    assert moe["w_gate"].shape == (cfg.num_layers, 8, cfg.d_model, cfg.d_ff)
    caches = tsteps._cache_structs(cfg, prof, tshape.global_batch,
                                   tshape.seq_len)
    c = caches["layers"][0]
    B, L = tshape.global_batch, c["k"].shape[2]
    if prof.kv_int8:
        assert set(c) == {"k", "v", "k_scale", "v_scale", "slot_pos"}
        assert c["k"].dtype == torch.int8
        assert c["k_scale"].shape == (cfg.num_layers, B, L, 8)
        assert c["k_scale"].dtype == torch.float32
    else:
        assert set(c) == {"k", "v", "slot_pos"}
        assert c["k"].dtype == torch.bfloat16
    jcaches = jax.eval_shape(lambda: jsteps.T.init_caches(
        jconfigs.get_config(arch), B, tshape.seq_len, jnp.bfloat16,
        quantized=prof.kv_int8))
    _same_specs(caches, jcaches)
    g = _flat(tsteps.cache_spec_tree(caches, got.meta["batch_axes"], tmesh))
    w = _flat(jsteps.cache_spec_tree(jcaches, want.meta["batch_axes"],
                                     jmesh))
    assert {k: JP(*s) for k, s in g.items()} == w


@pytest.mark.parametrize("arch", MOE)
def test_moe_bundle_functions_match_reference(arch, monkeypatch):
    """The MoE smoke variants through the bundles' functions, each with
    its profile's dispatch (scan) and cache (grok-1 int8)."""
    _bundle_functions_match(monkeypatch, arch, 7)


def test_build_step_routes_by_mode_and_train_specs_match(monkeypatch):
    """``build_step`` picks the builder from ``shape.mode``; the train
    bundle's ``in_specs`` (the (C, ...) stack, the (C, pcb, S) batch and
    the round index) equal the reference's on a 4-client mesh."""
    _, kw = _both(monkeypatch)
    for mode, builder in (("prefill", tsteps.build_prefill_step),
                          ("decode", tsteps.build_decode_step)):
        shape = tshapes.InputShape("s", SEQ, 2, mode)
        got = tsteps.build_step(ARCH, shape, None, num_clients=4, **kw)
        want = builder(ARCH, shape, None, **kw)
        assert got.meta == want.meta and got.fn.__name__ == want.fn.__name__
        for g, w in zip(_flat(got.in_specs).values(),
                        _flat(want.in_specs).values()):
            assert g.shape == w.shape and g.dtype == w.dtype
    shape = tshapes.InputShape("t", 32, 16, "train")
    got = tsteps.build_step(ARCH, shape, None, num_clients=4, num_clusters=2,
                            **kw)
    assert got.meta["mode"] == "train" and got.meta["form"] == "one-device"
    want = jsteps.build_train_step(
        ARCH, jshapes.InputShape("t", 32, 16, "train"),
        AbstractMesh((4, 1), ("data", "model")), num_clusters=2)
    assert got.meta["clusters"] == want.meta["clusters"]
    assert (got.meta["pcb"], got.meta["accum"]) == (want.meta["pcb"],
                                                    want.meta["accum"])
    for g, w in zip(got.in_specs, want.in_specs):
        _same_specs(g, w)


@pytest.mark.parametrize("shape", sorted(jshapes.SHAPES))
def test_shape_applicable_matches_reference(shape):
    for arch in jconfigs.ARCH_NAMES:
        want = jshapes.shape_applicable(jconfigs.get_config(arch),
                                        jshapes.SHAPES[shape])
        got = tshapes.shape_applicable(tconfigs.get_config(arch),
                                       tshapes.SHAPES[shape])
        assert got == want, (arch, shape)
