"""Tensor parallelism over "model" for the recurrent pair: the Mamba-2
SSD (mamba2-1.3b) by heads, its projection and conv cut part by part,
and the RG-LRU (recurrentgemma-2b, beside its local attention layers) by
channels (``models/{ssm,rglru}.py``, ``sharding/rules.py``), on the CPU,
in float32, against the port's one-device code and the reference, from
the same numpy inputs.

* Gloo ranks (``tests/torch_ranks.py``) on (1, 2), (2, 2) and (1, 4),
  each rank fed its blocks of the reference's parameters through
  ``rules.local_shard`` (``gather_full`` of them ``==`` the full tree,
  every leaf: the SSD's part-aware cut and the RG-LRU's blocks).  The
  smoke variants: mamba2's 16 heads of 32, state 32, chunk 32, a 40-token
  prompt (two chunks); recurrentgemma at 5 layers (a cycle of rglru,
  rglru, local and the 2 leftover rglru layers).  On (1, 4) two cases
  whose recurrent widths do not divide (2 SSD heads of 256; an RG-LRU
  width of 250): those layers stay whole on every rank.
* Serving: the prefill's last logits and 4 decode steps' logits meet the
  port's one-device ``prefill_last``/``decode_step`` and the reference's
  at 1e-4; each rank's caches are its blocks of the one-device caches
  under ``steps.cache_spec_tree`` (the SSD state by heads, its conv state
  part by part, the RG-LRU's by channels).
* Training: one round (K = 1) of the mesh ``build_train_step`` meets the
  one-device step and the reference's own step (a subprocess over 4 XLA
  host devices, on the same layout) on (2, 2), 2 clients of TP 2, and on
  (1, 2): new parameters at atol 1e-5, the mean loss at rtol 1e-5.
* Rank shapes at full size on 16-way "model", and a prefill's collective
  bytes against a hand count from the widths.
"""
import dataclasses
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as jmodel
from repro_torch import configs as tconfigs
from repro_torch.launch import dryrun
from repro_torch.launch import steps as tsteps
from repro_torch.models import model as tmodel
from repro_torch.models.transformer import params_from_numpy
from repro_torch.sharding import rules
from repro_torch.tree import tree_leaves, tree_map

from test_torch_tp import _assemble, _by_key, _close
from test_torch_tp_families import (BODY, REFERENCE, _as_torch, _cfgs,
                                    _one_device_round, _train_case)
from torch_ranks import Ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
S, STEPS = 40, 4
MAMBA, RG = "mamba2-1.3b", "recurrentgemma-2b"
RG5 = {"num_layers": 5}
# layout -> serving cases (arch, config overrides, batch)
SERVE = {
    (1, 2): [(MAMBA, {}, 2), (RG, RG5, 2)],
    (2, 2): [(MAMBA, {}, 4), (RG, RG5, 4)],
    (1, 4): [(MAMBA, {}, 2), (RG, RG5, 2),
             # the divisibility fallback: 2 heads, a width of 250 over 4
             (MAMBA, {"ssm_head_dim": 256}, 2),
             (RG, {**RG5, "lru_width": 250}, 2)],
}
# layout -> training cases (arch, config overrides, global batch)
TRAIN = {
    (2, 2): [(MAMBA, {}, 8), (RG, RG5, 8)],
    (1, 2): [(MAMBA, {}, 4), (RG, RG5, 4)],
}


def _serve_case(arch, over, batch, seed):
    jcfg, _ = _cfgs(arch, over)
    params = jax.tree_util.tree_map(np.asarray, jmodel.init_params(
        jcfg, jax.random.PRNGKey(seed), jnp.float32))
    toks = np.random.default_rng(seed + 1).integers(
        0, jcfg.vocab_size, (batch, S + STEPS), dtype=np.int32)
    return dict(arch=arch, over=over, prof_over={}, max_len=S + STEPS,
                params=params, tokens=toks, dispatches=["dense"], front={})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every layout's gloo ranks and the reference's subprocess, started
    together."""
    d = tmp_path_factory.mktemp("tp_recurrent")
    serve = {lay: [_serve_case(*c, seed=10 * i + 100 * j)
                   for i, c in enumerate(cs)]
             for j, (lay, cs) in enumerate(SERVE.items())}
    train = {lay: [_train_case(a, o, {}, b, S, "", lay,
                               seed=20 * i + 200 * j)
                   for i, (a, o, b) in enumerate(cs)]
             for j, (lay, cs) in enumerate(TRAIN.items())}
    with open(d / "cases.pkl", "wb") as f:
        pickle.dump({"train": [c for cs in train.values() for c in cs],
                     "serve": []}, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(d / "cases.pkl"),
         str(d / "ref.pkl")], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    ranks = {}
    for lay in SERVE:
        inputs = d / f"inputs_{lay[0]}x{lay[1]}.pt"
        torch.save({"serve": [_as_torch(c) for c in serve[lay]],
                    "train": [_as_torch(c) for c in train.get(lay, [])]},
                   inputs)
        spec = {"inputs": str(inputs), "layout": list(lay), "S": S,
                "STEPS": STEPS}
        ranks[lay] = Ranks(lay[0] * lay[1],
                           BODY.replace("SPEC", repr(spec)), d,
                           tag=f"tpr{lay[0]}x{lay[1]}", timeout=500)
    outs = {}
    for lay, r in ranks.items():
        r.wait()
        outs[lay] = [torch.load(f"{o}.pt", weights_only=False)
                     for o in r.outs]
    _, err = ref.communicate(timeout=600)
    assert ref.returncode == 0, err[-4000:]
    with open(d / "ref.pkl", "rb") as f:
        reference = pickle.load(f)
    return {"serve": serve, "train": train, "outs": outs,
            "reference": reference}


# ------------------------------------------------------------- serving

def _one_device(case):
    """The port's one-device prefill and decode of a serving case, and
    the reference's."""
    jcfg, tcfg = _cfgs(case["arch"], case["over"])
    toks = case["tokens"]
    tparams = params_from_numpy(case["params"], CPU)
    jparams = jax.tree_util.tree_map(jnp.asarray, case["params"])
    with torch.inference_mode():
        tl, tc = tmodel.prefill_last(
            tcfg, tparams, {"tokens": torch.from_numpy(toks[:, :S]).long()},
            case["max_len"])
        kept = tree_map(lambda x: x.clone(), tc)
        tdec = []
        for i in range(STEPS):
            lg, tc = tmodel.decode_step(
                tcfg, tparams, tc,
                torch.from_numpy(toks[:, S + i:S + i + 1]).long(), S + i)
            tdec.append(lg[:, 0])
    jl, jc = jmodel.prefill_last(jcfg, jparams,
                                 {"tokens": jnp.asarray(toks[:, :S])},
                                 case["max_len"])
    jdec = []
    for i in range(STEPS):
        lg, jc = jmodel.decode_step(jcfg, jparams, jc,
                                    jnp.asarray(toks[:, S + i:S + i + 1]),
                                    jnp.int32(S + i))
        jdec.append(np.asarray(lg[:, 0]))
    return (tl, torch.stack(tdec), kept), (np.asarray(jl), np.stack(jdec))


def _rank_caches(layout, rank, full):
    """Rank ``rank``'s blocks of the one-device caches ``full`` under
    ``steps.cache_spec_tree``: its rows, its heads of the SSD state and
    its part of the SSD conv state, its RG-LRU channels, its block of an
    attention cache's slots."""
    mesh = dryrun.ShapeMesh({"data": layout[0], "model": layout[1]})
    specs = tsteps.cache_spec_tree(full, "data", mesh)
    coords = {"data": rank // layout[1], "model": rank % layout[1]}
    return rules.local_shard(full, specs, mesh, coords)


@pytest.mark.parametrize("layout", list(SERVE), ids=lambda x: f"{x[0]}x{x[1]}")
def test_serving_on_mesh_matches_one_device_and_reference(runs, layout):
    """Prefill logits, 4 decode steps' logits and each rank's prefill
    caches on a gloo mesh against one device (the port's) and the
    reference."""
    outs = runs["outs"][layout]
    for i, case in enumerate(runs["serve"][layout]):
        _, tcfg = _cfgs(case["arch"], case["over"])
        (tl, tdec, kept), (jl, jdec) = _one_device(case)
        got = _assemble(layout, [o["serve"][i][0]["logits"] for o in outs],
                        tcfg.vocab_padded)
        dec = _assemble(layout, [o["serve"][i][0]["decode"] for o in outs],
                        tcfg.vocab_padded)
        assert got.shape == tl.shape, case["arch"]
        _close(got, tl, 1e-4)
        _close(got, jl, 1e-4)
        _close(dec, tdec, 1e-4)
        _close(dec, jdec, 1e-4)
        for rank, o in enumerate(outs):
            want = _rank_caches(layout, rank, kept)
            have = o["serve"][i][0]["caches"]
            for g, w in zip(tree_leaves(have), tree_leaves(want)):
                assert g.shape == w.shape, (case["arch"], g.shape, w.shape)
                _close(g, w, 1e-5)


def test_undivided_widths_stay_whole(runs):
    """The (1, 4) fallback cases: 2 SSD heads and an RG-LRU width of 250
    do not divide over 4 ranks, so each rank holds those layers whole
    (and their state), while the rest of the model is split."""
    outs = runs["outs"][(1, 4)]
    ssd = outs[0]["serve"][2][0]["caches"]["layers"][0]
    rg = outs[0]["serve"][3][0]["caches"]
    assert ssd["h"].shape[-3] == 2 and ssd["conv"].shape[-1] == 512 + 64
    assert rg["layers"][0]["h"].shape[-1] == 250
    assert rg["rem_layers"][0]["conv"].shape[-1] == 250
    # the split cases beside them: a rank's 4 of 16 heads, 64 of 256
    split = outs[0]["serve"][0][0]["caches"]["layers"][0]
    assert split["h"].shape[-3] == 4 and split["conv"].shape[-1] == 128 + 64
    assert outs[0]["serve"][1][0]["caches"]["layers"][0]["h"].shape[-1] == 64


# ------------------------------------------------------------ training

def _train_cases():
    return [(lay, i) for lay in TRAIN for i in range(len(TRAIN[lay]))]


def _train_id(key):
    arch = TRAIN[key[0]][key[1]][0]
    return f"{arch}-{key[0][0]}x{key[0][1]}"


@pytest.mark.parametrize("key", _train_cases(), ids=_train_id)
def test_train_round_on_mesh_matches_one_device_and_reference(runs, key):
    """One round (stage-1 of one cluster): every rank's client, gathered,
    against the one-device form and the reference's step on the same
    layout; the mean loss on every rank.  The SSD's B and C columns (of
    ``in_proj`` and of the conv) feed every rank's heads: their gradients
    are summed over "model", or they would be a rank's share."""
    layout, i = key
    case = runs["train"][layout][i]
    ref = runs["reference"]["train"][_train_cases().index(key)]
    one, one_loss = _one_device_round(case)
    for o in runs["outs"][layout]:
        got = o["train"][i]
        np.testing.assert_allclose(got["loss"], float(one_loss), rtol=1e-5)
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
        c = got["client"]
        for g, w1, w2 in _by_key(got["stack"], one, ref["stack"]):
            np.testing.assert_allclose(g.numpy(), w1[c].numpy(), rtol=0,
                                       atol=1e-5)
            np.testing.assert_allclose(g.numpy(), np.asarray(w2)[c],
                                       rtol=0, atol=1e-5)


# --------------------------------------------------- layout and bytes

def test_full_size_rank_blocks_on_16_way_model():
    """mamba2-1.3b and recurrentgemma-2b at full size on 16x16 (meta
    tensors: nothing allocated): a rank's SSD blocks are its 4 of 64
    heads (z, x, dt), all of B and C (2 x 128), its 256 of 4096 x
    channels of the conv, its heads of A_log, D and dt_bias, its 256
    channels of norm_scale and rows of out_proj; its RG-LRU blocks are
    160 of 2560 channels, ``lru_wa``/``lru_wx`` by columns.  The cache
    placements carry the same cut, and the dry run's rank arguments
    (``_local_specs``) are those shapes."""
    mesh = dryrun.ShapeMesh({"data": 16, "model": 16})
    coords = {"data": 0, "model": 3}
    cfg = tconfigs.get_config(MAMBA)
    prof = tconfigs.get_profile(MAMBA)
    structs = tsteps._param_structs(cfg)
    specs = tsteps.param_specs(cfg, prof, mesh)
    local = rules.local_shard(structs, specs, mesh, coords)
    ssd = local["layers"][0]["ssd"]
    assert ssd["in_proj"].shape == (48, 2048, 2 * 256 + 256 + 4)
    assert ssd["conv_w"].shape == (48, 4, 256 + 256)
    assert ssd["conv_b"].shape == (48, 512)
    assert all(ssd[k].shape == (48, 4) for k in ("A_log", "D", "dt_bias"))
    assert ssd["norm_scale"].shape == (48, 256)
    assert ssd["out_proj"].shape == (48, 256, 2048)
    pl = rules.tree_shardings(specs, mesh)
    args = dryrun._local_specs(structs, pl, [16, 16])
    assert [tuple(x.shape) for x in tree_leaves(args)] == \
        [tuple(x.shape) for x in tree_leaves(local)]
    caches = tsteps._cache_structs(cfg, prof, 16, 64)
    csp = tsteps.cache_spec_tree(caches, "data", mesh)
    c = rules.local_shard(caches, csp, mesh, coords)["layers"][0]
    assert c["h"].shape == (48, 1, 4, 64, 128)
    assert c["conv"].shape == (48, 1, 3, 256 + 256)

    cfg = tconfigs.get_config(RG)
    prof = tconfigs.get_profile(RG)
    local = rules.local_shard(tsteps._param_structs(cfg),
                              tsteps.param_specs(cfg, prof, mesh), mesh,
                              coords)
    rg = local["layers"][0]["rglru"]
    assert rg["w_x"].shape == rg["w_gate"].shape == (8, 2560, 160)
    assert rg["lru_wa"].shape == rg["lru_wx"].shape == (8, 2560, 160)
    assert rg["conv_w"].shape == (8, 4, 160)
    assert rg["w_out"].shape == (8, 160, 2560)
    caches = tsteps._cache_structs(cfg, prof, 16, 64)
    c = rules.local_shard(caches, tsteps.cache_spec_tree(caches, "data",
                                                         mesh),
                          mesh, coords)["rem_layers"][0]
    assert c["h"].shape == (1, 160) and c["conv"].shape == (1, 3, 160)


@pytest.mark.parametrize("arch", [MAMBA, RG])
def test_prefill_collective_bytes_equal_a_hand_count(arch):
    """A smoke prefill on (1, 2), rank 0, f32: over "model", the
    embedding's all-reduce (B S d) and, a layer, mamba2's ``out_proj``
    all-reduce (B S d) and its gated norm's sum of squares (B S); for
    recurrentgemma an RG-LRU layer's conv output gathered once (B S W,
    gathered) and two all-reduces (``w_out``, the MLP; B S d each), a
    local attention layer's K and V gathers (B S kv) and two all-reduces
    (the attention's output, the MLP)."""
    _, cfg = _cfgs(arch, RG5 if arch == RG else {})
    prof = dataclasses.replace(tconfigs.get_profile(arch),
                               param_dtype="float32")
    b, s, f32 = 2, 48, 4
    rec = dryrun.run_one(arch, "prefill_32k", "1x2", cfg=cfg, profile=prof,
                         batch=b, seq_len=s)
    assert rec["status"] == "ok", rec
    d, n, bs = cfg.d_model, cfg.num_layers, b * s
    if arch == MAMBA:
        want = {"all-reduce": f32 * (n * (bs * d + bs) + bs * d)}
    else:
        kinds = cfg.layer_kinds()
        rg, local = kinds.count("rglru"), kinds.count("local")
        assert (rg, local) == (4, 1)
        want = {"all-reduce": f32 * (n * 2 * bs * d + bs * d),
                "all-gather": f32 * (rg * bs * cfg.lru_width
                                     + local * 2 * bs * cfg.kv_dim)}
    got = rec["collectives_by_axis"]["model"]
    assert {k: v for k, v in got.items() if k != "total"} == want
    assert "data" not in rec["collectives_by_axis"]
