"""Tensor parallelism over "model" and FSDP over "data" for the mixtures
of experts (grok-1-314b, mixtral-8x22b), the encoder-decoder
(whisper-large-v3) and the vision front end (pixtral-12b): their mesh
programs (``models/moe.py``'s per-expert TP, the encoder and the
cross-attention of ``models/{transformer,attention}.py``, the patch
projection) on the CPU, in float32, against the port's one-device code
and the reference, from the same numpy inputs.

* Gloo ranks (``tests/torch_ranks.py``) on (1, 2), (2, 2) and (1, 4), each
  rank fed its blocks of the reference's parameters through
  ``rules.local_shard`` (``gather_full`` of them ``==`` the full tree,
  every leaf: the expert stacks, ``router``, ``proj``, ``enc_pos``, the
  encoder tree, the ``cross`` attention).
* Serving: the prefill's last-position logits and 4 decode steps' logits
  meet the port's one-device ``prefill_last``/``decode_step`` and the
  reference's at 1e-4 (grok-1's int8 cache against the reference at
  1e-3, the bar of ``test_torch_tp.py``); whisper's frames are encoded on
  the mesh and every decode step's cross-attention runs on the rank's
  heads; pixtral's patches lead the prompt.  Each MoE case runs the
  profiles' ``scan`` dispatch and ``dense``; one runs ``capacity`` on (1,
  2), and mixtral's ``capacity`` serve on (2, 2), its batch split over
  "data", is held against the reference's on the same mesh too: a
  rank's capacity and its slots' places count the whole batch, as the
  reference's do (the case's prompts draw from 3 token ids, so that some
  expert overflows a rank's own capacity: counted from one rank's rows,
  the run would drop other slots).  Each rank's caches are its blocks of
  the one-device ones.
* Training: one round (K = 1) of the mesh ``build_train_step`` meets the
  one-device step and the reference's own step (a subprocess over 4 XLA
  host devices, on the same layout): mixtral on (2, 2) (FSDP over "data"
  and TP) with its profile's grad_accum (each "data" rank runs whole
  microbatches) in the scan, dense and capacity dispatches, and with
  grad_accum 1 (each rank a share of the microbatch, the load-balance
  means summed over "data"; with the capacity dispatch too, a rank's
  capacity then the whole microbatch's); whisper on (2, 2) (2 clients of
  TP 2), grok-1 and pixtral on (1, 2); new parameters at atol 1e-5, the
  mean loss at rtol 1e-5.  Mixtral's round at its profile's own bf16
  accumulator meets one device and the reference at the bf16 bars of
  ``test_torch_train.py`` (2^-7 relative, 2^-5 of the leaf's largest
  magnitude).  The router's new weights are held on every rank apart.
* FSDP: every dispatch gathers one expert's blocks at a time, never the
  whole stack.
* Collective bytes: a MoE prefill's count equals a hand count from the
  widths (one B S d all-reduce a MoE layer).
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

from repro import configs as jconfigs
from repro.models import model as jmodel
from repro.models import transformer as jT
from repro_torch import configs as tconfigs
from repro_torch.configs.shapes import InputShape
from repro_torch.launch import dryrun
from repro_torch.launch import steps as tsteps
from repro_torch.models import model as tmodel
from repro_torch.models import transformer as tT
from repro_torch.models.transformer import params_from_numpy
from repro_torch.tree import tree_map

from test_torch_tp import _assemble, _by_key, _check_caches, _close
from torch_ranks import Ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
S, STEPS, LR = 80, 4, 0.05
INT8_DECODE_TOL = 1e-3
MOE_DISPATCHES = ("scan", "dense")
# layout -> serving cases (arch, config overrides, batch, cache length,
# dispatches[, the prompts' distinct token ids: a case held against the
# reference's serve on the same mesh])
SERVE = {
    (1, 2): [("grok-1-314b", {}, 2, S + STEPS, MOE_DISPATCHES + ("capacity",)),
             ("whisper-large-v3", {}, 2, S + STEPS, None),
             ("pixtral-12b", {}, 2, 32 + S + STEPS, None)],
    (2, 2): [("mixtral-8x22b", {}, 4, S + STEPS, MOE_DISPATCHES),
             ("mixtral-8x22b", {}, 4, S + STEPS, ("capacity",), 3),
             ("whisper-large-v3", {"num_kv_heads": 2}, 4, S + STEPS, None),
             ("pixtral-12b", {}, 4, 32 + S + STEPS, None)],
    # 2 heads of 32 over 4 ranks: a rank holds half a head (its q, K and
    # V columns gathered, the heads covering them computed)
    (1, 4): [("grok-1-314b", {"num_heads": 2, "num_kv_heads": 1}, 2,
              S + STEPS, MOE_DISPATCHES),
             ("whisper-large-v3", {"num_heads": 2, "num_kv_heads": 2}, 2,
              S + STEPS, None),
             ("pixtral-12b", {"num_heads": 2, "num_kv_heads": 1}, 2,
              32 + S + STEPS, None)],
}
# layout -> training cases (arch, config overrides, profile overrides,
# global batch, sequence, id suffix): mixtral on (2, 2) with its
# profile's grad_accum (8 microbatches of 1 row: each "data" rank runs
# its 4 whole ones), with the scan, dense and capacity dispatches (the
# latter two loop over the experts under FSDP), and with grad_accum 1 (a
# microbatch of 8 rows split over the 2 "data" ranks: the load-balance
# means summed over "data"); the MoE profiles' bfloat16 accumulators in
# float32 for the f32 bars (XLA on the CPU keeps a bf16 subtraction's
# excess precision, the port rounds it), and once as it is, at the bf16
# bars; pixtral's 48 positions hold 32 patches and 16 tokens
F32_ACC = {"accum_dtype": "float32"}
TRAIN = {
    (2, 2): [("mixtral-8x22b", {}, F32_ACC, 8, 32, ""),
             ("mixtral-8x22b", {}, {**F32_ACC, "moe_dispatch": "dense"}, 8,
              32, "-dense"),
             ("mixtral-8x22b", {}, {**F32_ACC, "moe_dispatch": "capacity"},
              8, 32, "-capacity"),
             ("mixtral-8x22b", {}, {**F32_ACC, "grad_accum": 1}, 8, 32,
              "-shares"),
             ("mixtral-8x22b", {}, {**F32_ACC, "grad_accum": 1,
                                    "moe_dispatch": "capacity"}, 8, 32,
              "-shares-capacity"),
             ("mixtral-8x22b", {}, {}, 8, 32, "-bf16acc"),
             ("whisper-large-v3", {}, {}, 8, 32, "")],
    (1, 2): [("grok-1-314b", {}, {"grad_accum": 2,
                                  "accum_dtype": "float32"}, 4, 32, ""),
             ("pixtral-12b", {}, {}, 4, 48, "")],
}

def _cfgs(arch, over):
    return (dataclasses.replace(
                jconfigs.smoke_variant(jconfigs.get_config(arch)), **over),
            dataclasses.replace(
                tconfigs.smoke_variant(tconfigs.get_config(arch)), **over))


def _profile(arch, over=None):
    return dataclasses.replace(tconfigs.get_profile(arch),
                               param_dtype="float32", **(over or {}))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rng(seed):
    return np.random.default_rng(seed)


def _front(cfg, seed, lead):
    """A front end's input, 0.1 * normal (lead + (frontend_len, d_model))
    float32, under its batch key; {} for a text-only arch."""
    if cfg.frontend == "none":
        return {}
    x = 0.1 * _rng(seed).standard_normal(
        tuple(lead) + (cfg.frontend_len, cfg.d_model)).astype(np.float32)
    return {"frames" if cfg.is_enc_dec else "patch_embeds": x}


# --------------------------------------------------------------- the runs

REFERENCE = r"""
import dataclasses, pickle, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_config, get_profile, smoke_variant
from repro.configs.shapes import InputShape
from repro.launch import steps
from repro.launch.mesh import make_test_mesh
with open(sys.argv[1], "rb") as f:
    cases = pickle.load(f)
out = {"train": [], "serve": []}
for case in cases["train"]:
    cfg = dataclasses.replace(smoke_variant(get_config(case["arch"])),
                              **case["over"])
    prof = dataclasses.replace(get_profile(case["arch"]),
                               param_dtype="float32", **case["prof_over"])
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
for case in cases["serve"]:
    # the serving bundles on the mesh: the prefill's last logits, then
    # each decode step's (B, V)
    cfg = dataclasses.replace(smoke_variant(get_config(case["arch"])),
                              **case["over"])
    prof = dataclasses.replace(get_profile(case["arch"]),
                               param_dtype="float32",
                               moe_dispatch=case["dispatch"])
    steps.get_config = lambda arch: cfg
    steps.get_profile = lambda arch: prof
    toks, S = case["tokens"], case["S"]
    B = toks.shape[0]
    mesh = make_test_mesh(tuple(case["layout"]))
    with mesh:
        pre = steps.build_prefill_step(case["arch"],
                                       InputShape("p", S, B, "prefill"), mesh)
        dec = steps.build_decode_step(case["arch"],
                                      InputShape("d", S, B, "decode"), mesh)
        params = jax.device_put(
            jax.tree_util.tree_map(jnp.asarray, case["params"]),
            pre.in_shardings[0])
        logits, caches = jax.jit(pre.fn, in_shardings=pre.in_shardings,
                                 out_shardings=pre.out_shardings)(
            params, {"tokens": jnp.asarray(toks[:, :S])})
        step = jax.jit(dec.fn, in_shardings=dec.in_shardings,
                       out_shardings=dec.out_shardings)
        rows = [np.asarray(logits)]
        for i in range(case["steps"]):
            logits, caches = step(params, caches,
                                  jnp.asarray(toks[:, S + i:S + i + 1]),
                                  jnp.int32(S + i))
            rows.append(np.asarray(logits))
    out["serve"].append(np.stack(rows, 1))
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""

BODY = r"""
import dataclasses
from repro_torch import configs
from repro_torch.configs.shapes import InputShape
from repro_torch.launch import steps
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.sharding import rules
from repro_torch.tree import tree_leaves, tree_map
spec = SPEC
S, STEPS = spec["S"], spec["STEPS"]
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
                               param_dtype="float32", **case["prof_over"])
    return cfg, prof, steps.param_specs(cfg, prof, mesh2)


for case in inp["serve"]:
    cfg, prof, specs = setup(case)
    local = rules.local_shard(case["params"], specs, mesh2)
    back = rules.gather_full(local, specs, mesh2)
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(back), tree_leaves(case["params"])))
    tp = steps.mesh_program(mesh2, prof)
    rows = case["tokens"].shape[0] // layout[0]
    lo = coords["data"] * rows
    toks = case["tokens"][lo:lo + rows]
    front = {k: v[lo:lo + rows] for k, v in case["front"].items()}
    off = cfg.frontend_len if "patch_embeds" in front else 0
    runs = []
    for dispatch in case["dispatches"]:
        with torch.inference_mode():
            batch = {"tokens": toks[:, :S]}
            enc = None
            if "frames" in front:
                enc = T.encode(cfg, local, front["frames"], mode="prefill",
                               tp=tp)
                batch["enc_out"] = enc
            if "patch_embeds" in front:
                batch["patch_embeds"] = front["patch_embeds"]
            logits, caches = M.prefill_last(
                cfg, local, batch, case["max_len"], dispatch=dispatch,
                quantized_cache=prof.kv_int8, tp=tp)
            kept = tree_map(lambda x: x.clone(), caches)
            dec = []
            for i in range(STEPS):
                lg, caches = M.decode_step(
                    cfg, local, caches, toks[:, S + i:S + i + 1],
                    off + S + i, enc_out=enc, dispatch=dispatch, tp=tp)
                dec.append(lg[:, 0])
        runs.append({"logits": logits, "decode": torch.stack(dec),
                     "caches": kept})
    out["serve"].append(runs)

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
                         "shares": b.meta["microbatch_shares"],
                         "rank_accum": b.meta["rank_accum"],
                         "stack": rules.gather_full(
                             tree_map(lambda x: x[0], new), specs, mesh2)})
torch.save(out, sys.argv[4] + ".pt")
"""


def _serve_case(arch, over, batch, max_len, dispatches, distinct=None, *,
                seed):
    jcfg, _ = _cfgs(arch, over)
    params = _np(jmodel.init_params(jcfg, jax.random.PRNGKey(seed),
                                    jnp.float32))
    toks = _rng(seed + 1).integers(0, distinct or jcfg.vocab_size,
                                   (batch, S + STEPS), dtype=np.int32)
    return dict(arch=arch, over=over, prof_over={}, max_len=max_len,
                on_mesh=distinct is not None,
                params=params, tokens=toks,
                dispatches=list(dispatches or ("dense",)),
                front=_front(jcfg, seed + 2, (batch,)))


def _train_case(arch, over, prof_over, batch, seq, tag, layout, seed):
    jcfg, _ = _cfgs(arch, over)
    prof = jconfigs.get_profile(arch)
    c = layout[0] if prof.client_axis == "data" else 1
    clients = [jmodel.init_params(jcfg, jax.random.PRNGKey(seed + i),
                                  jnp.float32) for i in range(c)]
    stack = _np(jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *clients))
    text = seq - (jcfg.frontend_len if jcfg.frontend == "vision" else 0)
    toks = _rng(seed + 7).integers(0, jcfg.vocab_size,
                                   (c, batch // c, text + 1), dtype=np.int32)
    b = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    b.update(_front(jcfg, seed + 8, (c, batch // c)))
    return dict(arch=arch, over=over, prof_over=prof_over,
                layout=list(layout), S=seq, B=batch, lr=LR, stack=stack,
                batch=b)


def _as_torch(case):
    case = dict(case)
    for key in ("params", "stack"):
        if key in case:
            case[key] = params_from_numpy(case[key], CPU)
    if "tokens" in case:
        case["tokens"] = torch.from_numpy(case["tokens"]).long()
    for key in ("batch", "front"):
        if key in case:
            case[key] = {k: torch.from_numpy(v)
                         for k, v in case[key].items()}
    return case


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every layout's gloo ranks and the reference's subprocess, started
    together: {"serve": {layout: [case]}, "train": ..., "outs": {layout:
    [rank outs]}, "reference": the subprocess's train results}."""
    d = tmp_path_factory.mktemp("tp_families")
    serve = {lay: [_serve_case(*c, seed=10 * i + 100 * j)
                   for i, c in enumerate(cs)]
             for j, (lay, cs) in enumerate(SERVE.items())}
    train = {lay: [_train_case(*c, layout=lay, seed=20 * i + 200 * j)
                   for i, c in enumerate(cs)]
             for j, (lay, cs) in enumerate(TRAIN.items())}
    on_mesh = [dict(c, layout=list(lay), dispatch=c["dispatches"][0], S=S,
                    steps=STEPS)
               for lay, cs in serve.items() for c in cs if c["on_mesh"]]
    with open(d / "cases.pkl", "wb") as f:
        pickle.dump({"train": [c for cs in train.values() for c in cs],
                     "serve": on_mesh}, f)
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
                           tag=f"tpf{lay[0]}x{lay[1]}", timeout=500)
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

def _one_device(case, dispatch):
    """The port's one-device prefill and decode of a serving case, and
    the reference's, with ``dispatch``."""
    jcfg, tcfg = _cfgs(case["arch"], case["over"])
    quant = tconfigs.get_profile(case["arch"]).kv_int8
    tparams = params_from_numpy(case["params"], CPU)
    jparams = jax.tree_util.tree_map(jnp.asarray, case["params"])
    toks, front = case["tokens"], case["front"]
    off = tcfg.frontend_len if "patch_embeds" in front else 0
    tb = {"tokens": torch.from_numpy(toks[:, :S]).long()}
    jb = {"tokens": jnp.asarray(toks[:, :S])}
    t_enc = j_enc = None
    with torch.inference_mode():
        if "frames" in front:
            t_enc = tT.encode(tcfg, tparams, torch.from_numpy(front["frames"]),
                              mode="prefill")
            j_enc = jT.encode(jcfg, jparams, jnp.asarray(front["frames"]))
            tb["enc_out"], jb["enc_out"] = t_enc, j_enc
        if "patch_embeds" in front:
            tb["patch_embeds"] = torch.from_numpy(front["patch_embeds"])
            jb["patch_embeds"] = jnp.asarray(front["patch_embeds"])
        tl, tc = tmodel.prefill_last(tcfg, tparams, tb, case["max_len"],
                                     dispatch=dispatch, quantized_cache=quant)
        kept = tree_map(lambda x: x.clone(), tc)
        tdec = []
        for i in range(STEPS):
            lg, tc = tmodel.decode_step(
                tcfg, tparams, tc,
                torch.from_numpy(toks[:, S + i:S + i + 1]).long(),
                off + S + i, enc_out=t_enc, dispatch=dispatch)
            tdec.append(lg[:, 0])
    jl, jc = jmodel.prefill_last(jcfg, jparams, jb, case["max_len"],
                                 dispatch=dispatch, quantized_cache=quant)
    jdec = []
    for i in range(STEPS):
        lg, jc = jmodel.decode_step(
            jcfg, jparams, jc, jnp.asarray(toks[:, S + i:S + i + 1]),
            jnp.int32(off + S + i), enc_out=j_enc, dispatch=dispatch)
        jdec.append(np.asarray(lg[:, 0]))
    return (tl, torch.stack(tdec), kept), (np.asarray(jl), np.stack(jdec))


def _rank_overflow(case, data: int) -> int:
    """The slots of the one-device prefill's routing past their expert's
    capacity counted on one "data" rank's rows alone (``data`` ranks of
    the batch's rows), summed over the layers and ranks: 0 where counting
    a rank's own rows would drop nothing the whole batch keeps."""
    from repro_torch.models import moe
    _, tcfg = _cfgs(case["arch"], case["over"])
    routes, real = [], moe.router_probs

    def recording(*args, **kw):
        got = real(*args, **kw)
        routes.append(got[1])
        return got
    moe.router_probs = recording
    try:
        with torch.inference_mode():
            tmodel.prefill_last(
                tcfg, params_from_numpy(case["params"], CPU),
                {"tokens": torch.from_numpy(case["tokens"][:, :S]).long()},
                case["max_len"], dispatch="capacity")
    finally:
        moe.router_probs = real
    e = tcfg.num_experts
    over = 0
    for idx in routes:                              # (B, S, k) a layer
        for part in idx.chunk(data, 0):
            counts = torch.bincount(part.reshape(-1), minlength=e)
            cap = moe.capacity(part.shape[0] * part.shape[1], tcfg)
            over += int((counts - cap).clamp_min(0).sum())
    return over


@pytest.mark.parametrize("layout", list(SERVE), ids=lambda x: f"{x[0]}x{x[1]}")
def test_serving_on_mesh_matches_one_device_and_reference(runs, layout):
    """Prefill logits, 4 decode steps' logits and each rank's caches on a
    gloo mesh against one device (the port's) and the reference, for each
    case's dispatches; a case marked so against the reference's serving
    bundles on the same mesh too (mixtral's capacity dispatch, its batch
    split over "data": some expert overflows a rank's own capacity)."""
    outs = runs["outs"][layout]
    on_mesh = iter(runs["reference"]["serve"][sum(
        c["on_mesh"] for lay in SERVE if lay < layout
        for c in runs["serve"][lay]):])
    for i, case in enumerate(runs["serve"][layout]):
        _, tcfg = _cfgs(case["arch"], case["over"])
        quant = tconfigs.get_profile(case["arch"]).kv_int8
        for j, dispatch in enumerate(case["dispatches"]):
            (tl, tdec, kept), (jl, jdec) = _one_device(case, dispatch)
            got = _assemble(layout, [o["serve"][i][j]["logits"]
                                     for o in outs], tcfg.vocab_padded)
            dec = _assemble(layout, [o["serve"][i][j]["decode"]
                                     for o in outs], tcfg.vocab_padded)
            assert got.shape == tl.shape, (case["arch"], dispatch)
            _close(got, tl, 1e-4)
            _close(got, jl, 1e-4)
            _close(dec, tdec, 1e-4)
            _close(dec, jdec, INT8_DECODE_TOL if quant else 1e-4)
            for rank, o in enumerate(outs):
                _check_caches(layout, rank, o["serve"][i][j]["caches"], kept)
            if case["on_mesh"]:
                assert _rank_overflow(case, layout[0]) > 0
                ref = next(on_mesh)
                _close(got, ref[:, 0], 1e-4)
                _close(dec, ref[:, 1:].transpose(1, 0, 2), 1e-4)


# ------------------------------------------------------------ training

def _one_device_round(case):
    _, tcfg = _cfgs(case["arch"], case["over"])
    c = case["stack"]["final_norm"]["scale"].shape[0]
    b = tsteps.build_train_step(
        case["arch"], InputShape("t", case["S"], case["B"], "train"), None,
        num_clients=c, num_clusters=1, lr=LR, rounds_per_global=2,
        cfg=tcfg, profile=_profile(case["arch"], case["prof_over"]))
    stack = params_from_numpy(case["stack"], CPU)
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    return b.fn(stack, batch, 0)


def _train_cases():
    return [(lay, i) for lay in TRAIN for i in range(len(TRAIN[lay]))]


BF16_ACC = ((2, 2), [c[-1] for c in TRAIN[(2, 2)]].index("-bf16acc"))


def _train_id(key):
    arch, *_, tag = TRAIN[key[0]][key[1]]
    return f"{arch}-{key[0][0]}x{key[0][1]}{tag}"


@pytest.fixture(scope="module")
def one_rounds(runs):
    return {key: _one_device_round(runs["train"][key[0]][key[1]])
            for key in _train_cases()}


@pytest.mark.parametrize("key", _train_cases(), ids=_train_id)
def test_train_round_on_mesh_matches_one_device_and_reference(
        runs, one_rounds, key):
    """One round (stage-1 of one cluster): every rank's client, gathered,
    against the one-device form and the reference's step on the same
    layout; the mean loss on every rank."""
    layout, i = key
    case = runs["train"][layout][i]
    ref = runs["reference"]["train"][_train_cases().index(key)]
    one, one_loss = one_rounds[key]
    # f32 bars; at the profile's bf16 accumulator, test_torch_train.py's
    # bf16 bars (2^-7 relative, 2^-5 of the leaf's largest magnitude)
    rtol, atol_frac = (2 ** -7, 2 ** -5) if key == BF16_ACC else (0, 0)
    outs = runs["outs"][layout]
    if case["arch"] == "mixtral-8x22b":
        # grad_accum 1: each rank took its share of the microbatch; else
        # it ran its whole ones, (8 / grad_accum) / 2 of them
        shares = case["prof_over"].get("grad_accum") == 1
        assert all(o["train"][i]["shares"] == shares for o in outs)
        assert all(o["train"][i]["rank_accum"] == (1 if shares else 4)
                   for o in outs)
    for o in outs:
        got = o["train"][i]
        np.testing.assert_allclose(got["loss"], float(one_loss), rtol=1e-5)
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
        c = got["client"]
        for g, w1, w2 in _by_key(got["stack"], one, ref["stack"]):
            for w in (w1[c].numpy(), np.asarray(w2)[c]):
                atol = (atol_frac * max(float(np.abs(w).max()), 1e-30)
                        if atol_frac else 1e-5)
                np.testing.assert_allclose(g.numpy(), w, rtol=rtol,
                                           atol=atol)


@pytest.mark.parametrize("key", [k for k in _train_cases()
                                 if TRAIN[k[0]][k[1]][0].endswith(
                                     ("314b", "8x22b"))],
                         ids=_train_id)
def test_router_update_on_every_rank_matches_one_device(runs, one_rounds,
                                                        key):
    """The router is replicated over "model": every rank's new router
    (its own, with its "data" blocks gathered) is the one-device round's,
    and moved
    from the start.  Each rank's router gradient is whole only where
    ``combine`` enters the experts through ``copy_to_model`` (its
    gradient from the rank's partial expert outputs summed over
    "model")."""
    layout, i = key
    case = runs["train"][layout][i]
    one, _ = one_rounds[key]
    start = params_from_numpy(case["stack"], CPU)
    want = [lp["moe"]["router"] for lp in one["layers"] if "moe" in lp]
    was = [lp["moe"]["router"] for lp in start["layers"] if "moe" in lp]
    assert want
    for o in runs["outs"][layout]:
        got = [lp["moe"]["router"] for lp in o["train"][i]["stack"]["layers"]
               if "moe" in lp]
        c = o["train"][i]["client"]
        assert len(got) == len(want)
        for g, w, w0 in zip(got, want, was):
            if key == BF16_ACC:    # the bf16 bars (see the round's test)
                np.testing.assert_allclose(
                    g.numpy(), w[c].numpy(), rtol=2 ** -7,
                    atol=2 ** -5 * float(w[c].abs().max()))
            else:
                np.testing.assert_allclose(g.numpy(), w[c].numpy(), rtol=0,
                                           atol=1e-6)
            assert float((w[c] - w0[c]).abs().max()) > 1e-4


# --------------------------------------------------------------- bytes

def test_moe_prefill_collective_bytes_equal_a_hand_count():
    """grok-1-314b's smoke prefill on (1, 2), rank 0, f32, the scan
    dispatch: over "model" a layer, the attention's output all-reduce (B
    S d), the K and V all-gathers (B S kv, gathered) and the MoE layer's
    one all-reduce of its experts' summed partial outputs (B S d, not one
    an expert); the routing agreed (the first rank's (B, S, k) int64
    top-k indices broadcast); the embedding's all-reduce (B S d)."""
    cfg = tconfigs.smoke_variant(tconfigs.get_config("grok-1-314b"))
    b, s, f32 = 2, 48, 4
    prof = _profile("grok-1-314b")
    assert prof.moe_dispatch == "scan"
    rec = dryrun.run_one("grok-1-314b", "prefill_32k", "1x2", cfg=cfg,
                         profile=prof, batch=b, seq_len=s)
    d, kv, n, k = cfg.d_model, cfg.kv_dim, cfg.num_layers, \
        cfg.experts_per_token
    assert cfg.num_experts > 1
    want = {"all-reduce": f32 * (n * 2 * b * s * d + b * s * d),
            "all-gather": f32 * n * 2 * b * s * kv,
            "broadcast": 8 * n * b * s * k}
    got = rec["collectives_by_axis"]["model"]
    assert {key: v for key, v in got.items() if key != "total"} == want
    assert "data" not in rec["collectives_by_axis"]


@pytest.mark.parametrize("grad", [False, True], ids=["serve", "train"])
@pytest.mark.parametrize("dispatch", ["scan", "dense", "capacity"])
def test_fsdp_gathers_one_expert_at_a_time(monkeypatch, dispatch, grad):
    """Under FSDP every dispatch gathers an expert's blocks over "data"
    one expert at a time, never the (E, d, f) stack: every gather is of
    a 2-D block (an expert's, or the router's).  One process: a "data"
    size of 2 whose gather stacks the block twice (the layer's numbers
    are not held here, only what it gathers)."""
    from repro_torch.models import moe
    from repro_torch.sharding import parallel as P
    cfg = tconfigs.smoke_variant(tconfigs.get_config("mixtral-8x22b"))
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    gen = torch.Generator().manual_seed(0)
    full = moe.init_moe(cfg, gen, torch.float32, CPU)
    half = {"router": full["router"][: d // 2],
            "w_gate": full["w_gate"][:, : d // 2],
            "w_up": full["w_up"][:, : d // 2],
            "w_down": full["w_down"][..., : d // 2]}
    if grad:
        half = {k: v.requires_grad_(True) for k, v in half.items()}
    shapes = []

    def gather(tp, w, dim, n):
        if w.shape[dim] == n:
            return w
        shapes.append(tuple(w.shape))
        return torch.cat([w, w], dim)
    monkeypatch.setattr(moe.P, "fsdp_gather", gather)
    tp = P.TP(group=None, size=1, rank=0, data_size=2)
    x = torch.randn((2, 8, d), generator=gen)
    with torch.set_grad_enabled(grad):
        y, aux = moe.apply_moe(cfg, half, x, dispatch, tp=tp)
        if grad:
            (y.square().sum() + aux).backward()
    assert y.shape == x.shape
    assert (d // 2, e) in shapes
    experts = [s for s in shapes if s != (d // 2, e)]
    assert experts and all(s in ((d // 2, f), (f, d // 2)) for s in experts)
    if grad:
        assert all(v.grad is not None for v in half.values())
