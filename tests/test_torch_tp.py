"""Tensor parallelism over "model" and FSDP over "data": the dense
transformers' mesh program (``sharding/parallel.py`` and the mesh paths of
``models/{layers,attention,transformer,model}.py``,
``launch/steps.py``, ``core/aggregation_spmd.py``) on the CPU, in
float32, against the port's one-device step and the reference's step,
from the same numpy inputs.

* Gloo ranks (``tests/torch_ranks.py``) on three layouts, (1, 2), (2, 2)
  and (1, 4), each rank fed its blocks of the reference's parameters
  through ``rules.local_shard`` (and ``gather_full`` of them ``==`` the
  full tree).  Smoke variants of the four dense archs, with cases whose
  kv heads are fewer than the model size (a rank holds part of a kv
  head) and whose q heads are too (part of a q head), an int8 cache
  (qwen2-72b's profile), ring caches (a prompt longer than gemma2's
  window), a cache whose slots do not split (the fallback to whole), and
  FSDP with the batch over "data" (granite-3-8b on (2, 2)).
* Serving: the prefill's last-position logits (each rank's vocab slice,
  assembled) and 4 decode steps' logits meet the port's one-device
  ``prefill_last``/``decode_step`` and the reference's at 1e-4 (the
  serving bundles' bar, ``test_torch_steps.py``; against the reference,
  an int8 cache's decode logits at 1e-3, where the two packages round a
  cache value one step apart, as the one-device port does too); each
  rank's prefill
  caches are its blocks of the one-device caches (slots split over
  "model" where they divide, ``slot_pos`` whole) at 1e-5, int8 values
  within ``test_torch_kv_int8.INT8_FLIPS``.
* Training: one round (K = 1, stage-1) of the mesh form of
  ``build_train_step`` meets the one-device form and the reference's own
  step (a subprocess over 4 XLA host devices, on the same layout): the
  new client parameters at atol 1e-5, the mean loss at rtol 1e-5
  (``test_torch_train.py``'s f32 bars).
* Bytes: each rank's argument and output bytes of the train, prefill
  and decode bundles (counted on fake tensors as rank 0 of a fake (2, 2)
  group) equal the reference's ``memory_summary`` of the same bundles
  compiled on ``make_test_mesh((2, 2))``, up to the two differences
  ``test_torch_dryrun.py`` names (XLA's output tuple table, 8 bytes a
  leaf; an argument jit drops unread) and the round index, a 0-d int32
  there and a Python int here (4 bytes where the reference reads it).
* Collective bytes: the count of a prefill (FSDP, (2, 2)) and of a
  train step ((1, 2)) equals a hand count from the widths.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import configs as jconfigs
from repro.models import model as jmodel
from repro_torch import configs as tconfigs
from repro_torch.configs.shapes import InputShape
from repro_torch.launch import dryrun
from repro_torch.launch import hlo_analysis as H
from repro_torch.launch import steps as tsteps
from repro_torch.models import model as tmodel
from repro_torch.models.transformer import params_from_numpy
from repro_torch.tree import tree_map

from test_torch_kv_int8 import assert_int8_close
from torch_ranks import Ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
S, STEPS, LR, TRAIN_S = 80, 4, 0.05, 32
INT8_DECODE_TOL = 1e-3
# layout -> serving cases (arch, config overrides, batch, cache length)
SERVE = {
    (1, 2): [("gemma2-2b", {}, 2, S + STEPS),
             ("qwen2-72b", {"num_kv_heads": 1}, 2, S + STEPS)],
    (2, 2): [("granite-3-8b", {}, 4, S + STEPS),
             ("h2o-danube-1.8b", {"num_kv_heads": 1}, 4, S + STEPS)],
    # 82 slots do not split over 4: the global layer's cache stays whole
    (1, 4): [("gemma2-2b", {"num_heads": 2, "num_kv_heads": 1}, 2, 82)],
}
# layout -> training cases (arch, config overrides, global batch)
TRAIN = {
    (2, 2): [("gemma2-2b", {}, 8), ("granite-3-8b", {}, 8)],
    (1, 2): [("h2o-danube-1.8b", {"num_kv_heads": 1}, 4)],
    (1, 4): [("qwen2-72b", {"num_heads": 2, "num_kv_heads": 1}, 4)],
}


def _cfgs(arch, over):
    return (dataclasses.replace(
                jconfigs.smoke_variant(jconfigs.get_config(arch)), **over),
            dataclasses.replace(
                tconfigs.smoke_variant(tconfigs.get_config(arch)), **over))


def _profile(arch):
    return dataclasses.replace(tconfigs.get_profile(arch),
                               param_dtype="float32")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


# --------------------------------------------------------------- the runs

REFERENCE = r"""
import dataclasses, json, pickle, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_config, get_profile, smoke_variant
from repro.configs.shapes import InputShape
from repro.launch import hlo_analysis as H
from repro.launch import steps
from repro.launch.mesh import make_test_mesh
with open(sys.argv[1], "rb") as f:
    cases = pickle.load(f)
out = {"train": [], "memory": {}}
for case in cases["train"]:
    cfg = dataclasses.replace(smoke_variant(get_config(case["arch"])),
                              **case["over"])
    prof = dataclasses.replace(get_profile(case["arch"]),
                               param_dtype="float32")
    steps.get_config = lambda arch: cfg
    steps.get_profile = lambda arch: prof
    mesh = make_test_mesh(tuple(case["layout"]))
    with mesh:
        b = steps.build_train_step(
            case["arch"], InputShape("t", case["S"], case["B"], "train"),
            mesh, num_clusters=1, lr=case["lr"], rounds_per_global=2)
        stack = jax.tree_util.tree_map(jnp.asarray, case["stack"])
        batch = {k: jnp.asarray(v) for k, v in case["batch"].items()}
        new, loss = jax.jit(b.fn)(stack, batch, jnp.int32(0))
    out["train"].append({"stack": jax.tree_util.tree_map(np.asarray, new),
                         "loss": float(loss)})
for arch, shapes in cases["memory"].items():
    cfg = smoke_variant(get_config(arch))
    prof = dataclasses.replace(get_profile(arch), param_dtype="float32")
    steps.get_config = lambda arch: cfg
    steps.get_profile = lambda arch: prof
    mesh = make_test_mesh((2, 2))
    for mode, (seq, batch) in shapes.items():
        with mesh:
            kw = {"num_clusters": 1} if mode == "train" else {}
            b = steps.build_step(arch, InputShape("s", seq, batch, mode),
                                 mesh, **kw)
            donate = {"train": (0,), "decode": (1,)}.get(mode, ())
            compiled = jax.jit(b.fn, in_shardings=b.in_shardings,
                               out_shardings=b.out_shardings,
                               donate_argnums=donate).lower(
                *b.in_specs).compile()
        out["memory"][f"{arch}/{mode}"] = {
            "memory": H.memory_summary(compiled),
            "collectives": H.collective_bytes(compiled.as_text())}
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""

BODY = r"""
import dataclasses
from repro_torch import configs
from repro_torch.configs.shapes import InputShape
from repro_torch.launch import steps
from repro_torch.models import model as M
from repro_torch.sharding import rules
from repro_torch.tree import tree_leaves, tree_map
spec = SPEC
inp = torch.load(spec["inputs"], weights_only=False)
layout = tuple(spec["layout"])
mesh2 = mesh_lib.make_test_mesh(layout, ("data", "model"))
coords = rules.coordinates(mesh2)
out = {"serve": [], "train": []}


def setup(case):
    cfg = dataclasses.replace(
        configs.smoke_variant(configs.get_config(case["arch"])),
        **case["over"])
    prof = dataclasses.replace(configs.get_profile(case["arch"]),
                               param_dtype="float32")
    return cfg, prof, steps.param_specs(cfg, prof, mesh2)


for case in inp["serve"]:
    cfg, prof, specs = setup(case)
    local = rules.local_shard(case["params"], specs, mesh2)
    back = rules.gather_full(local, specs, mesh2)
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(back), tree_leaves(case["params"])))
    tp = steps.mesh_program(mesh2, prof)
    toks = case["tokens"]
    rows = toks.shape[0] // layout[0]
    toks = toks[coords["data"] * rows:(coords["data"] + 1) * rows]
    serve = dict(quantized_cache=prof.kv_int8)
    with torch.inference_mode():
        logits, caches = M.prefill_last(cfg, local, {"tokens": toks[:, :S]},
                                        case["max_len"], tp=tp, **serve)
        kept = tree_map(lambda x: x.clone(), caches)
        dec = []
        for i in range(STEPS):
            lg, caches = M.decode_step(cfg, local, caches,
                                       toks[:, S + i:S + i + 1], S + i,
                                       tp=tp)
            dec.append(lg[:, 0])
    out["serve"].append({"logits": logits, "decode": torch.stack(dec),
                         "caches": kept})

for case in inp["train"]:
    cfg, prof, specs = setup(case)
    b = steps.build_train_step(
        case["arch"], InputShape("t", case["S"], case["B"], "train"), mesh2,
        num_clusters=1, lr=case["lr"], rounds_per_global=2, cfg=cfg,
        profile=prof)
    table = mesh_lib.client_rank_table(
        mesh2, mesh_lib.client_axes_for(mesh2, prof.client_axis))
    c = next(i for i, row in enumerate(table) if rank in row)
    stack = tree_map(lambda x: x[None], rules.local_shard(
        tree_map(lambda x: x[c], case["stack"]), specs, mesh2))
    rows, pcb = b.meta["rank_rows"], b.meta["pcb"]
    lo = coords["data"] * rows if rows != pcb else 0
    batch = {k: v[c:c + 1, lo:lo + rows] for k, v in case["batch"].items()}
    new, loss = b.fn(stack, batch, 0)
    out["train"].append({"client": c, "loss": float(loss),
                         "stack": rules.gather_full(
                             tree_map(lambda x: x[0], new), specs, mesh2)})
torch.save(out, sys.argv[4] + ".pt")
"""
BODY = BODY.replace("S + i", f"{S} + i").replace(
    "[:, :S]", f"[:, :{S}]").replace("range(STEPS)", f"range({STEPS})")


def _serve_case(arch, over, batch, max_len, seed):
    jcfg, _ = _cfgs(arch, over)
    params = _np(jmodel.init_params(jcfg, jax.random.PRNGKey(seed),
                                    jnp.float32))
    toks = _tokens(seed + 1, (batch, S + STEPS), jcfg.vocab_size)
    return dict(arch=arch, over=over, max_len=max_len, params=params,
                tokens=toks)


def _train_case(arch, over, batch, layout, seed):
    jcfg, tcfg = _cfgs(arch, over)
    prof = jconfigs.get_profile(arch)
    c = layout[0] if prof.client_axis == "data" else 1
    clients = [jmodel.init_params(jcfg, jax.random.PRNGKey(seed + i),
                                  jnp.float32) for i in range(c)]
    stack = _np(jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *clients))
    toks = _tokens(seed + 7, (c, batch // c, TRAIN_S + 1), jcfg.vocab_size)
    return dict(arch=arch, over=over, layout=list(layout), S=TRAIN_S,
                B=batch, lr=LR, stack=stack,
                batch={"tokens": toks[..., :-1], "labels": toks[..., 1:]})


def _as_torch(case):
    case = dict(case)
    for key in ("params", "stack"):
        if key in case:
            case[key] = params_from_numpy(case[key], CPU)
    if "tokens" in case:
        case["tokens"] = torch.from_numpy(case["tokens"]).long()
    if "batch" in case:
        case["batch"] = {k: torch.from_numpy(v)
                         for k, v in case["batch"].items()}
    return case


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every layout's gloo ranks and the reference's subprocess, started
    together: {"serve": {layout: [(case, [rank outs])]}, "train": ...,
    "reference": the subprocess's results}."""
    import pickle
    d = tmp_path_factory.mktemp("tp")
    seed = 0
    serve = {lay: [_serve_case(*c, seed=seed + 10 * i)
                   for i, c in enumerate(cs)] for lay, cs in SERVE.items()}
    train = {lay: [_train_case(a, o, b, lay, seed=seed + 20 * i)
                   for i, (a, o, b) in enumerate(cs)]
             for lay, cs in TRAIN.items()}
    ref_cases = {"train": [c for cs in train.values() for c in cs],
                 "memory": {arch: MEMORY_SHAPES for arch in MEMORY_ARCHS}}
    with open(d / "cases.pkl", "wb") as f:
        pickle.dump(ref_cases, f)
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
        spec = {"inputs": str(inputs), "layout": list(lay)}
        ranks[lay] = Ranks(lay[0] * lay[1],
                           BODY.replace("SPEC", repr(spec)), d,
                           tag=f"tp{lay[0]}x{lay[1]}", timeout=400)
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


MEMORY_ARCHS = ("gemma2-2b", "granite-3-8b")
MEMORY_SHAPES = {"train": (TRAIN_S, 8), "prefill": (S, 4), "decode": (S, 4)}


# ------------------------------------------------------------- serving

def _assemble(layout, parts, vocab_padded):
    """The (rows, V) logits of a layout's ranks, in rank order (data
    major): each rank's rows and vocab slice."""
    d, m = layout
    blocks = [torch.cat([parts[i * m + j] for j in range(m)], -1)
              if parts[i * m].shape[-1] != vocab_padded else parts[i * m]
              for i in range(d)]
    return torch.cat(blocks, -2)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _one_device(case):
    """The port's one-device prefill and decode of a serving case, and
    the reference's."""
    jcfg, tcfg = _cfgs(case["arch"], case["over"])
    quant = tconfigs.get_profile(case["arch"]).kv_int8
    tparams = params_from_numpy(case["params"], CPU)
    toks = case["tokens"]
    with torch.inference_mode():
        tl, tc = tmodel.prefill_last(
            tcfg, tparams, {"tokens": torch.from_numpy(toks[:, :S]).long()},
            case["max_len"], quantized_cache=quant)
        kept = tree_map(lambda x: x.clone(), tc)
        tdec = []
        for i in range(STEPS):
            lg, tc = tmodel.decode_step(
                tcfg, tparams, tc, torch.from_numpy(toks[:, S + i:S + i + 1])
                .long(), S + i)
            tdec.append(lg[:, 0])
    jl, jc = jmodel.prefill_last(jcfg, jax.tree_util.tree_map(
        jnp.asarray, case["params"]), {"tokens": jnp.asarray(toks[:, :S])},
        case["max_len"], quantized_cache=quant)
    jdec = []
    for i in range(STEPS):
        lg, jc = jmodel.decode_step(
            jcfg, jax.tree_util.tree_map(jnp.asarray, case["params"]), jc,
            jnp.asarray(toks[:, S + i:S + i + 1]), jnp.int32(S + i))
        jdec.append(np.asarray(lg[:, 0]))
    return (tl, torch.stack(tdec), kept), (np.asarray(jl), np.stack(jdec))


def _check_caches(layout, rank, local, full):
    """A rank's prefill caches are its blocks of the one-device caches:
    its rows of the batch, its block of slots where they split over
    "model" (else all of them), ``slot_pos`` whole."""
    d, m = layout
    di = rank // m
    for lw, fw in zip(local["layers"] + local["rem_layers"],
                      full["layers"] + full["rem_layers"]):
        lead = fw["slot_pos"].dim() - 1
        assert torch.equal(lw["slot_pos"], fw["slot_pos"])
        for key in lw:
            if key == "slot_pos":
                continue
            b = fw[key].shape[lead] // d
            L, Ll = fw[key].shape[lead + 1], lw[key].shape[lead + 1]
            lo = (rank % m) * Ll if Ll != L else 0
            want = fw[key].narrow(lead, di * b, b).narrow(lead + 1, lo, Ll)
            if lw[key].dtype == torch.int8:
                assert_int8_close(lw[key].numpy(), want.numpy(), what=key)
            else:
                _close(lw[key], want, 1e-5)
            if m > 1 and L % m == 0:
                assert Ll == L // m, (key, Ll, L)


@pytest.mark.parametrize("layout", list(SERVE), ids=lambda x: f"{x[0]}x{x[1]}")
def test_serving_on_mesh_matches_one_device_and_reference(runs, layout):
    """Prefill logits, 4 decode steps' logits and each rank's caches on a
    gloo mesh against one device (the port's) and the reference."""
    outs = runs["outs"][layout]
    for i, case in enumerate(runs["serve"][layout]):
        _, tcfg = _cfgs(case["arch"], case["over"])
        (tl, tdec, kept), (jl, jdec) = _one_device(case)
        got = _assemble(layout, [o["serve"][i]["logits"] for o in outs],
                        tcfg.vocab_padded)
        dec = _assemble(layout, [o["serve"][i]["decode"] for o in outs],
                        tcfg.vocab_padded)
        assert got.shape == tl.shape
        _close(got, tl, 1e-4)
        _close(got, jl, 1e-4)
        _close(dec, tdec, 1e-4)
        # an int8 cache value may round one step apart between the two
        # packages (ROADMAP section 3: up to 6.4e-4 of a decode's logits);
        # the one-device port then sits as far from the reference
        quant = tconfigs.get_profile(case["arch"]).kv_int8
        _close(dec, jdec, INT8_DECODE_TOL if quant else 1e-4)
        _close(tdec, jdec, INT8_DECODE_TOL if quant else 1e-4)
        for rank, o in enumerate(outs):
            _check_caches(layout, rank, o["serve"][i]["caches"], kept)


# ------------------------------------------------------------ training

def _one_device_round(case):
    _, tcfg = _cfgs(case["arch"], case["over"])
    c = case["stack"]["final_norm"]["scale"].shape[0]
    b = tsteps.build_train_step(
        case["arch"], InputShape("t", case["S"], case["B"], "train"), None,
        num_clients=c, num_clusters=1, lr=LR, rounds_per_global=2,
        cfg=tcfg, profile=_profile(case["arch"]))
    stack = params_from_numpy(case["stack"], CPU)
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    return b.fn(stack, batch, 0)


def _by_key(tree, *others):
    """(leaf, the others' leaves at the same path): dicts matched by key
    (the reference's trees come back with their keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in tree for x in _by_key(
            tree[k], *(o[k] for o in others))]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree) for x in _by_key(
            v, *(o[i] for o in others))]
    return [(tree,) + others]


@pytest.mark.parametrize("layout", list(TRAIN), ids=lambda x: f"{x[0]}x{x[1]}")
def test_train_round_on_mesh_matches_one_device_and_reference(runs, layout):
    """One round (stage-1 of one cluster): every rank's client, gathered,
    against the one-device form and the reference's step on the same
    layout; the mean loss on every rank."""
    outs = runs["outs"][layout]
    first = [c for lay in TRAIN for c in TRAIN[lay]].index(TRAIN[layout][0])
    for i, case in enumerate(runs["train"][layout]):
        ref = runs["reference"]["train"][first + i]
        one, one_loss = _one_device_round(case)
        for o in outs:
            got = o["train"][i]
            np.testing.assert_allclose(got["loss"], float(one_loss),
                                       rtol=1e-5)
            np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
            c = got["client"]
            for g, w1, w2 in _by_key(got["stack"], one, ref["stack"]):
                np.testing.assert_allclose(g.numpy(), w1[c].numpy(), rtol=0,
                                           atol=1e-5)
                np.testing.assert_allclose(g.numpy(), np.asarray(w2)[c],
                                           rtol=0, atol=1e-5)


# --------------------------------------------------------------- bytes

def _port_memory(arch, mode):
    """Rank 0's counted memory and collectives of a bundle on a fake (2,
    2) mesh."""
    from torch.distributed.device_mesh import init_device_mesh
    _, tcfg = _cfgs(arch, {})
    seq, batch = MEMORY_SHAPES[mode]
    with H.fake_process_group(4):
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data",
                                                               "model"))
        shape = InputShape("s", seq, batch, mode)
        kw = {"num_clusters": 1} if mode == "train" else {}
        b = tsteps.build_step(arch, shape, mesh, cfg=tcfg,
                              profile=_profile(arch), **kw)
        n = 2 if mode == "train" else len(b.in_specs)
        args = dryrun._local_specs(b.in_specs[:n], b.in_shardings[:n],
                                   [2, 2])
        if mode == "train":
            c = H.count(b.fn, args + (0,), device="meta", trips=True)
        else:
            c = H.count(b.fn, args, device="meta")
    assert not dist.is_initialized()
    return b, c


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", MEMORY_ARCHS)
def test_rank_bytes_match_reference_memory_summary(runs, arch, mode):
    """A rank's argument and output bytes against the reference's
    per-device ``memory_summary`` on ``make_test_mesh((2, 2))``:
    gemma2-2b (2 clients of TP 2) and granite-3-8b (FSDP over "data")."""
    want = runs["reference"]["memory"][f"{arch}/{mode}"]["memory"]
    b, c = _port_memory(arch, mode)
    got = H.memory_summary(c)
    # the round index: a 0-d int32 the reference reads where stage-1
    # runs over several clients, a Python int here
    unread = -4 if (mode == "train" and b.meta["n_clients"] > 1) else 0
    assert got["argument_size_in_bytes"] - unread == \
        want["argument_size_in_bytes"]
    assert got["output_size_in_bytes"] + 8 * c["n_outputs"] == \
        want["output_size_in_bytes"]


def _widths(cfg):
    return cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff, cfg.vocab_padded


def test_prefill_collective_bytes_equal_a_hand_count():
    """granite-3-8b's smoke prefill on (2, 2), rank 0 (2 of the 4 rows,
    FSDP over "data"), f32: over "model", 2 all-reduces of B S d a layer
    (attention and MLP outputs), the K and V all-gathers (B S kv a
    layer, gathered), the embedding's all-reduce (B S d); over "data",
    every FSDP leaf all-gathered at use (its model block whole over
    d_model): the tied embedding twice (lookup and logits)."""
    cfg = tconfigs.smoke_variant(tconfigs.get_config("granite-3-8b"))
    b, s, f32 = 2, 48, 4
    rec = dryrun.run_one("granite-3-8b", "prefill_32k", "2x2", cfg=cfg,
                         profile=_profile("granite-3-8b"), batch=2 * b,
                         seq_len=s)
    d, q, kv, ff, vp = _widths(cfg)
    n = cfg.num_layers
    model = {"all-reduce": f32 * (n * 2 * b * s * d + b * s * d),
             "all-gather": f32 * n * 2 * b * s * kv}
    per_layer = (d * q + 2 * d * kv + q * d + 3 * d * ff) // 2
    data = {"all-gather": f32 * (n * per_layer + 2 * (vp // 2) * d)}
    got = rec["collectives_by_axis"]
    assert {k: v for k, v in got["model"].items() if k != "total"} == model
    assert {k: v for k, v in got["data"].items() if k != "total"} == data


def test_train_collective_bytes_equal_a_hand_count():
    """h2o-danube-1.8b's smoke train step on (1, 2) (one client, TP 2, no
    FSDP), rank 0, one microbatch of b rows counted and scaled by its
    trips, f32.  Forward: 2 all-reduces of B S d a layer, the K and V
    gathers (B S kv), the embedding's all-reduce, the loss's max, sum of
    exp and target logit over the B (S - 1) positions.  Backward: the
    all-reduces of the two column-parallel inputs' gradients (attention
    and MLP, B S d a layer), of the unembedding input's (B S d), and the
    K and V gradients reduce-scattered (B S kv / 2).  Remat runs each
    layer's forward again as far as its last saved activation
    (``torch.utils.checkpoint`` stops early): the K and V gathers and the
    attention's all-reduce, not the MLP's.  Then the client's loss agreed
    across "model" (a 4-byte broadcast); one client: no aggregation."""
    cfg = tconfigs.smoke_variant(tconfigs.get_config("h2o-danube-1.8b"))
    prof = _profile("h2o-danube-1.8b")
    assert prof.remat
    s, batch = 40, 4
    rec = dryrun.run_one("h2o-danube-1.8b", "train_4k", "1x2", cfg=cfg,
                         profile=prof, global_batch=batch, seq_len=s,
                         clusters=1)
    accum = rec["meta"]["rank_accum"]
    micro = batch // accum
    d, q, kv, ff, vp = _widths(cfg)
    n, f32, bs = cfg.num_layers, 4, micro * s
    layer_ar = 2 * bs * d
    layer_ag = 2 * bs * kv
    fwd_ar = n * layer_ar + bs * d + 2 * micro * (s - 1)   # + sum of exp, ll
    fwd_max = micro * (s - 1)
    bwd_ar = n * 2 * bs * d + bs * d
    recompute_ar = n * bs * d
    want = {"all-reduce": f32 * accum * (fwd_ar + fwd_max + recompute_ar
                                         + bwd_ar),
            "all-gather": f32 * accum * 2 * n * layer_ag,
            "reduce-scatter": f32 * accum * n * layer_ag // 2,
            "broadcast": f32}
    got = rec["collectives_by_axis"]["model"]
    assert {k: v for k, v in got.items() if k != "total"} == want
    assert "clients" not in rec["collectives_by_axis"]
