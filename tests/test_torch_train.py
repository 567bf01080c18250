"""The port's transformer training slice against the JAX package, on the
CPU, in float32, from the same inputs: numpy draws and the reference's own
parameters carried across (``models/transformer.params_from_numpy``).

* ``cross_entropy`` and ``loss_fn`` (value and ``jax.grad``) on the smoke
  variants of gemma2-2b (local + global layers, soft-caps, post-norms) and
  h2o-danube-1.8b (sliding window, untied unembed): rtol 1e-5, and an atol
  of 1e-5 of the leaf's largest gradient (both sides sum the same
  products in other orders; a gradient element that cancels to ~0 has no
  relative precision).
* The train attention route, ``chunk_attention`` and
  ``windowed_full_attention`` (a window shorter than the sequence, so the
  windowed branch runs), forward and q/k/v gradients: 1e-5.
* Train mode never reaches ``ops.flash_attention``; ``remat=True`` equals
  ``remat=False`` with ``==``.
* ``balanced_clusters`` equals the reference's.
* ``build_train_step``: the reference's own step (shard_map over 4 XLA host
  devices, ``make_test_mesh((4, 1))``, the smoke variant, an f32 profile)
  runs in a subprocess for two rounds, C = 4, K = 2, ``rounds_per_global``
  2 (round 0 stage-1 only, round 1 with stage-2).  The port's one-device
  form (kernels off, the plain stage-1 on the CPU) and its mesh form on
  4 gloo ranks meet it: new client parameters at atol 1e-5, the mean loss
  at rtol 1e-5.  One bf16 round meets the reference's bf16 round at
  rtol 2^-7 (two bf16 ulps of the element) and an atol of 2^-5 of the
  leaf's largest magnitude; its loss within 1e-2 relative.  Both sides
  round activations and gradients to bf16 at other places: weights land
  within one ulp, but the norm scales start at zero, so after one step
  they are lr times a bf16 gradient, which differ by 1-2% of the leaf's
  scale between the two packages.
* The same step for the recurrent families' smoke variants (mamba2-1.3b:
  SSD blocks; recurrentgemma-2b: RG-LRU blocks beside a local attention
  layer), each against the reference's own step run in its subprocess:
  two f32 rounds at the same bars (loss rtol 1e-5, stack atol 1e-5) and
  one bf16 round at the bf16 bars above, but for mamba2-1.3b's atol,
  2^-4 of the leaf's largest magnitude (BF16_ATOL_FRAC).  Its
  zero-initialized leaves (norm scales, ``conv_b``, ``dt_bias``) are lr
  times a bf16 gradient after the round, and on one microbatch of the
  smoke model the reference's bf16 gradient is up to 2.9% of a leaf's
  largest magnitude from the f32 gradient of the same bf16 parameters,
  the port's up to 2.7% (1.7% at ``norm1``, where the reference's is
  2.9%): the two land up to 4.0% apart after a round (6 of 2,048
  elements of ``norm1`` past 2^-5).  Both packages keep ``A_log``, ``D``
  and ``dt_bias`` in f32 in a bf16 model, and so does the stack here.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import clustering as jcl
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro_torch import configs as tconfigs
from repro_torch.configs.shapes import InputShape
from repro_torch.core import aggregation as tagg
from repro_torch.core import clustering as tcl
from repro_torch.kernels import ops
from repro_torch.launch import steps as tsteps
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.models.transformer import params_from_numpy
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

from torch_ranks import Ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
ARCHS = ("gemma2-2b", "h2o-danube-1.8b")
C, K, S, GLOBAL_BATCH, LR, RPG = 4, 2, 32, 16, 0.05, 2
BF16_ATOL_FRAC = {"mamba2-1.3b": 2**-4}      # else 2^-5 (see above)


def _cfgs(arch):
    return (jconfigs.smoke_variant(jconfigs.get_config(arch)),
            tconfigs.smoke_variant(tconfigs.get_config(arch)))


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def _close_tree(got, want, rtol, atol_frac):
    """``got`` (port tree of tensors) against ``want`` (the reference's
    tree of arrays), leaf by leaf with an atol of ``atol_frac`` of the
    leaf's largest magnitude."""
    def one(g, w):
        w = np.asarray(w, np.float32)
        g = g.detach().float().numpy()
        np.testing.assert_allclose(
            g, w, rtol=rtol, atol=atol_frac * max(float(np.abs(w).max()),
                                                  1e-30))
    tree_map(one, got, want)


# ------------------------------------------------------------------- loss

def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((2, 7, 33)) * 4).astype(np.float32)
    labels = rng.integers(0, 33, (2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) > 0.3).astype(np.float32)
    for m in (None, mask):
        want = jmodel.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                    None if m is None else jnp.asarray(m))
        got = tmodel.cross_entropy(torch.from_numpy(logits),
                                   torch.from_numpy(labels),
                                   None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # a bf16 input is reduced in f32
    got = tmodel.cross_entropy(torch.from_numpy(logits).bfloat16(),
                               torch.from_numpy(labels))
    assert got.dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_value_and_gradients_match_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(3))
    toks = _tokens(1, (2, 41), jcfg.vocab_size)
    jb = {"tokens": jnp.asarray(toks[:, :-1]),
          "labels": jnp.asarray(toks[:, 1:])}
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jmodel.loss_fn(jcfg, p, jb), has_aux=True)(jp)

    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), CPU)
    leaves = [x.requires_grad_(True) for x in tree_leaves(tp)]
    tp = tree_unflatten(tp, leaves)
    tl, tm = tmodel.loss_fn(tcfg, tp, {"tokens": torch.from_numpy(toks[:, :-1]),
                                       "labels": torch.from_numpy(toks[:, 1:])})
    grads = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tm["ce"].detach()), float(jm["ce"]), rtol=1e-5)
    assert float(tm["aux"]) == float(jm["aux"]) == 0.0
    _close_tree(tree_unflatten(tp, list(grads)),
                jax.tree_util.tree_map(np.asarray, jg), 1e-5, 1e-5)


# ---------------------------------------------------------- train attention

def _qkv(seed, b, s, hq, hkv, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for h in (hq, hkv, hkv)]


@pytest.mark.parametrize("route", ["chunk", "chunk-window", "windowed"])
def test_train_attention_matches_reference(route):
    """Forward and q/k/v gradients (a vjp of a random cotangent).  The
    chunks are small so the sequence pads to them; ``windowed`` has
    Sk > window + q_chunk, so the per-chunk K/V slices run."""
    jcfg, tcfg = _cfgs("gemma2-2b")          # attn soft-cap 50
    B, Sq, Hq, Hkv, D = 2, 70, 4, 2, 32
    q, k, v = _qkv(5, B, Sq, Hq, Hkv, D)
    pos = np.arange(Sq, dtype=np.int32)
    cot = np.random.default_rng(6).standard_normal((B, Sq, Hq, D)).astype(
        np.float32)
    if route == "windowed":
        jfn = lambda q, k, v: jattn.windowed_full_attention(   # noqa: E731
            jcfg, q, k, v, jnp.asarray(pos), jnp.asarray(pos), 24,
            q_chunk=16)
        tfn = lambda q, k, v: tattn.windowed_full_attention(   # noqa: E731
            tcfg, q, k, v, torch.from_numpy(pos), torch.from_numpy(pos), 24,
            q_chunk=16)
    else:
        window = 24 if route == "chunk-window" else 0
        jfn = lambda q, k, v: jattn.chunk_attention(   # noqa: E731
            jcfg, q, k, v, jnp.asarray(pos), jnp.asarray(pos), causal=True,
            window=window, q_chunk=16, kv_chunk=32)
        tfn = lambda q, k, v: tattn.chunk_attention(   # noqa: E731
            tcfg, q, k, v, torch.from_numpy(pos), torch.from_numpy(pos),
            causal=True, window=window, q_chunk=16, kv_chunk=32)
    jout, vjp = jax.vjp(jfn, *map(jnp.asarray, (q, k, v)))
    jgrads = vjp(jnp.asarray(cot))
    tq, tk, tv = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    tout = tfn(tq, tk, tv)
    tgrads = torch.autograd.grad(tout, (tq, tk, tv), torch.from_numpy(cot))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    for g, w in zip(tgrads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_mode_never_calls_flash_attention(arch, monkeypatch):
    """A forward and backward in train mode with ``ops.flash_attention``
    made to raise: the chunked route is the only one taken."""
    def boom(*a, **k):
        raise AssertionError("train mode reached ops.flash_attention")
    monkeypatch.setattr(ops, "flash_attention", boom)
    _, tcfg = _cfgs(arch)
    p = tmodel.init_params(tcfg, torch.Generator().manual_seed(0))
    leaves = [x.requires_grad_(True) for x in tree_leaves(p)]
    toks = torch.from_numpy(_tokens(2, (1, 17), tcfg.vocab_size))
    for remat in (False, True):
        loss, _ = tmodel.loss_fn(tcfg, tree_unflatten(p, leaves),
                                 {"tokens": toks, "labels": toks},
                                 remat=remat)
        loss.backward()
    assert all(x.grad is not None for x in leaves)


@pytest.mark.parametrize("arch", ARCHS + ("mamba2-1.3b", "recurrentgemma-2b",
                                          "mixtral-8x22b"))
def test_remat_equals_no_remat(arch):
    """``remat=True`` (each cycle under a non-reentrant checkpoint) gives
    the loss and gradients of ``remat=False`` with ``==``: the SSD and
    RG-LRU blocks write nothing in place in train mode (a recomputed
    in-place write would raise or differ), and the MoE's scan dispatch
    nests a checkpoint an expert inside the cycle's."""
    _, tcfg = _cfgs(arch)
    dispatch = tconfigs.get_profile(arch).moe_dispatch
    p = tmodel.init_params(tcfg, torch.Generator().manual_seed(4))
    toks = torch.from_numpy(_tokens(3, (2, 25), tcfg.vocab_size))
    out = []
    for remat in (False, True):
        leaves = [x.detach().requires_grad_(True) for x in tree_leaves(p)]
        loss, _ = tmodel.loss_fn(tcfg, tree_unflatten(p, leaves),
                                 {"tokens": toks, "labels": toks},
                                 dispatch=dispatch, remat=remat)
        out.append((loss, torch.autograd.grad(loss, leaves)))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


# ---------------------------------------------------------------- clusters

@pytest.mark.parametrize("seed", range(4))
def test_balanced_clusters_matches_reference(seed):
    rng = np.random.default_rng(seed)
    k, cap = 3 + seed % 2, 4
    a = rng.integers(0, k, k * cap).astype(np.int32)   # unbalanced draws
    if seed == 3:
        a[:5] = k + 2                                   # out of range: spill
    want = jcl.balanced_clusters(jnp.asarray(a), k, cap)
    got = tcl.balanced_clusters(torch.from_numpy(a), k, cap)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------- train step

REFERENCE = r"""
import dataclasses, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_config, get_profile, smoke_variant
from repro.configs.shapes import InputShape
from repro.launch import steps
from repro.launch.mesh import make_test_mesh
from repro.models import model as M

spec = {spec}
batches = np.load(sys.argv[1])
out = {{}}
arch = spec["arch"]
cfg = smoke_variant(get_config(arch))
steps.get_config = lambda arch: cfg
mesh = make_test_mesh((spec["C"], 1))
for dtype, rounds in (("float32", 2), ("bfloat16", 1)):
    prof = dataclasses.replace(get_profile(arch), param_dtype=dtype)
    steps.get_profile = lambda arch: prof
    with mesh:
        bundle = steps.build_train_step(
            arch, InputShape("t", spec["S"], spec["B"], "train"), mesh,
            num_clusters=spec["K"], lr=spec["lr"],
            rounds_per_global=spec["rpg"])
        assert bundle.meta["clusters"] == ((0, 1), (2, 3)), bundle.meta
        clients = [M.init_params(cfg, jax.random.PRNGKey(c), jnp.dtype(dtype))
                   for c in range(spec["C"])]
        stack = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *clients)
        fn = jax.jit(bundle.fn)
        trees = [stack]
        for r in range(rounds):
            toks = batches[f"r{{r}}"]
            batch = {{"tokens": jnp.asarray(toks[..., :-1]),
                     "labels": jnp.asarray(toks[..., 1:])}}
            stack, loss = fn(stack, batch, jnp.int32(r))
            trees.append(stack)
            out[f"{{dtype}}/loss{{r}}"] = np.float32(loss)
        for i, tree in enumerate(trees):
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
                key = f"{{dtype}}/s{{i}}" + jax.tree_util.keystr(path)
                out[key] = np.asarray(x.astype(jnp.float32))
np.savez(sys.argv[2], **out)
"""


def _keystr(tree, prefix=""):
    """{jax keystr: leaf} of a port tree (dicts and tuples)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_keystr(v, f"{prefix}['{k}']"))
        return out
    if isinstance(tree, tuple):
        out = {}
        for i, v in enumerate(tree):
            out.update(_keystr(v, f"{prefix}[{i}]"))
        return out
    return {prefix: tree}


def _from_npz(npz, prefix, like, dtype):
    """A port tree shaped as ``like`` from the reference's leaves, each in
    ``like``'s dtype for it: ``dtype`` (the profile's), except the leaves
    both packages keep in f32 (the SSD's ``A_log``, ``D``, ``dt_bias``)."""
    keys = _keystr(like)
    leaves = [torch.from_numpy(npz[prefix + k]).to(x.dtype)
              for k, x in keys.items()]
    assert {x.dtype for x in leaves} <= {dtype, torch.float32}
    return tree_unflatten(like, leaves)


def _run_reference(d, arch):
    """The reference's two f32 rounds and one bf16 round of ``arch``'s
    smoke variant (npz) and the batches they ran on."""
    _, tcfg = _cfgs(arch)
    batches = {f"r{r}": _tokens(10 + r, (C, GLOBAL_BATCH // C, S + 1),
                                tcfg.vocab_size) for r in range(2)}
    np.savez(d / "batches.npz", **batches)
    spec = dict(arch=arch, C=C, K=K, S=S, B=GLOBAL_BATCH, lr=LR, rpg=RPG)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    res = subprocess.run(
        [sys.executable, "-c", REFERENCE.format(spec=spec),
         str(d / "batches.npz"), str(d / "ref.npz")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return d, np.load(d / "ref.npz"), batches


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """gemma2-2b's reference rounds."""
    return _run_reference(tmp_path_factory.mktemp("train_ref"), "gemma2-2b")


@pytest.fixture(scope="module", params=["mamba2-1.3b", "recurrentgemma-2b"])
def recurrent_reference(request, tmp_path_factory):
    """A recurrent family's reference rounds: (arch, dir, npz, batches)."""
    arch = request.param
    return (arch,) + _run_reference(tmp_path_factory.mktemp("train_ref"),
                                    arch)


def _port_step(dtype, mesh=None, arch="gemma2-2b", **kw):
    _, tcfg = _cfgs(arch)
    prof = dataclasses.replace(tconfigs.get_profile(arch),
                               param_dtype=dtype)
    return tsteps.build_train_step(
        arch, InputShape("t", S, GLOBAL_BATCH, "train"), mesh,
        num_clusters=K, lr=LR, rounds_per_global=RPG, cfg=tcfg,
        profile=prof, **kw), tcfg


def _like(tcfg, dtype):
    """The port's client-stacked tree structure (zeros)."""
    p = tmodel.init_params(dataclasses.replace(tcfg, dtype=dtype),
                           torch.Generator().manual_seed(0))
    return tagg.broadcast_global(p, C)


def _batch(toks):
    t = torch.from_numpy(toks)
    return {"tokens": t[..., :-1], "labels": t[..., 1:]}


def _check_round(got_stack, npz, key, dtype, rtol, atol_frac):
    want = {k[len(key):]: npz[k] for k in npz.files if k.startswith(key + "[")}
    got = _keystr(got_stack)
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].detach().float().numpy()
        np.testing.assert_allclose(
            g, w, rtol=rtol,
            atol=atol_frac if dtype == "float32"
            else atol_frac * max(float(np.abs(w).max()), 1e-30),
            err_msg=f"{key}{k}")


def _f32_rounds_match(npz, batches, arch="gemma2-2b"):
    bundle, tcfg = _port_step("float32", num_clients=C, arch=arch)
    assert bundle.meta["clusters"] == ((0, 1), (2, 3))
    assert (bundle.meta["pcb"], bundle.meta["accum"]) == (4, 4)
    stack = _from_npz(npz, "float32/s0", _like(tcfg, "float32"),
                      torch.float32)
    for r in range(2):
        stack, loss = bundle.fn(stack, _batch(batches[f"r{r}"]), r)
        np.testing.assert_allclose(float(loss), float(npz[f"float32/loss{r}"]),
                                   rtol=1e-5)
        _check_round(stack, npz, f"float32/s{r + 1}", "float32", 0, 1e-5)
    # after the stage-2 round every client holds the one global model
    for x in tree_leaves(stack):
        assert all(torch.equal(x[0], x[c]) for c in range(1, C))


def test_train_step_one_device_matches_reference(reference):
    """Round 0 (stage-1 only) and round 1 (stage-2), f32: the one-device
    form over the (C, ...) stack, ``hierarchical_round`` with the kernels
    off (the CPU's plain stage-1), against the reference's shard_map
    step."""
    _, npz, batches = reference
    _f32_rounds_match(npz, batches)


def _bf16_round_matches(npz, batches, arch="gemma2-2b"):
    bundle, tcfg = _port_step("bfloat16", num_clients=C, arch=arch)
    assert bundle.meta["dtype"] == "bfloat16"
    like = _like(tcfg, "bfloat16")
    stack = _from_npz(npz, "bfloat16/s0", like, torch.bfloat16)
    stack, loss = bundle.fn(stack, _batch(batches["r0"]), 0)
    # bf16, but for the leaves both packages keep in f32
    assert [x.dtype for x in tree_leaves(stack)] == [
        x.dtype for x in tree_leaves(like)]
    assert sum(x.dtype == torch.bfloat16 for x in tree_leaves(stack)) >= 8
    np.testing.assert_allclose(float(loss), float(npz["bfloat16/loss0"]),
                               rtol=1e-2)
    _check_round(stack, npz, "bfloat16/s1", "bfloat16", 2**-7,
                 BF16_ATOL_FRAC.get(arch, 2**-5))


def test_train_step_bf16_round_matches_reference(reference):
    """One bf16 round (bf16 parameters, f32 accumulation) at a looser
    bound: two bf16 ulps of each element and 2^-5 of the leaf's scale (the
    zero-initialized norm scales are pure bf16 gradients after one step);
    the loss within 1e-2 relative."""
    _, npz, batches = reference
    _bf16_round_matches(npz, batches)


def test_recurrent_train_step_f32_rounds_match_reference(
        recurrent_reference):
    """mamba2-1.3b and recurrentgemma-2b (smoke) through the one-device
    step: rounds 0 and 1 (stage-2) in f32 at the gemma2 bars."""
    arch, _, npz, batches = recurrent_reference
    _f32_rounds_match(npz, batches, arch)


def test_recurrent_train_step_bf16_round_matches_reference(
        recurrent_reference):
    """One bf16 round of each recurrent family at the bf16 bars (mamba2's
    atol: BF16_ATOL_FRAC)."""
    arch, _, npz, batches = recurrent_reference
    _bf16_round_matches(npz, batches, arch)


MESH_BODY = """
import dataclasses
from repro_torch import configs
from repro_torch.configs.shapes import InputShape
from repro_torch.launch import steps
from repro_torch.tree import tree_map
mesh2 = mesh_lib.make_test_mesh((world, 1), ("data", "model"))
spec = SPEC
cfg = configs.smoke_variant(configs.get_config("gemma2-2b"))
prof = dataclasses.replace(configs.get_profile("gemma2-2b"),
                           param_dtype="float32")
bundle = steps.build_train_step(
    "gemma2-2b", InputShape("t", spec["S"], spec["B"], "train"), mesh2,
    num_clusters=spec["K"], lr=spec["lr"], rounds_per_global=spec["rpg"],
    cfg=cfg, profile=prof)
inputs = torch.load(spec["inputs"])
stack = tree_map(lambda x: x[rank:rank + 1].clone(), inputs["stack"])
losses = []
for r in range(2):
    batch = {k: v[rank:rank + 1] for k, v in inputs["batches"][r].items()}
    stack, loss = bundle.fn(stack, batch, r)
    losses.append(float(loss))
    torch.save(stack, sys.argv[4] + f".r{r}.pt")
result["meta"] = {k: bundle.meta[k] for k in ("form", "n_clients", "pcb")}
result["losses"] = losses
"""


def test_train_step_mesh_form_matches_reference(reference, tmp_path):
    """The mesh form: 4 gloo ranks, one client a rank (``make_test_mesh((4,
    1))``), ``hierarchical_agg_shard`` over one process group a cluster,
    against the same reference rounds."""
    _, npz, batches = reference
    _, tcfg = _cfgs("gemma2-2b")
    stack = _from_npz(npz, "float32/s0", _like(tcfg, "float32"),
                      torch.float32)
    torch.save({"stack": stack,
                "batches": [_batch(batches[f"r{r}"]) for r in range(2)]},
               tmp_path / "inputs.pt")
    spec = dict(K=K, S=S, B=GLOBAL_BATCH, lr=LR, rpg=RPG,
                inputs=str(tmp_path / "inputs.pt"))
    ranks = Ranks(C, MESH_BODY.replace("SPEC", repr(spec)), tmp_path,
                  tag="train", timeout=300)
    results = ranks.wait()
    for rank, res in enumerate(results):
        assert res["meta"] == {"form": "mesh", "n_clients": C, "pcb": 4}
        for r in range(2):
            np.testing.assert_allclose(res["losses"][r],
                                       float(npz[f"float32/loss{r}"]),
                                       rtol=1e-5)
    for r in range(2):
        rows = [torch.load(f"{out}.r{r}.pt") for out in ranks.outs]
        got = tree_map(lambda *xs: torch.cat(xs), *rows)
        _check_round(got, npz, f"float32/s{r + 1}", "float32", 0, 1e-5)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-2b"])
def test_train_cli_runs_recurrent_archs_on_cpu(arch, capsys):
    """``python -m repro_torch.launch.train --arch <recurrent> --smoke
    --device cpu``: two rounds (stage-2 in the second), finite CE, the
    clients equal after the stage-2."""
    from repro_torch.launch import train as train_lib
    train_lib.main(["--arch", arch, "--smoke", "--device", "cpu",
                    "--rounds", "2"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["arch"] == arch + "-smoke" and out["dtype"] == "bfloat16"
    assert [r["did_global"] for r in out["rounds"]] == [False, True]
    assert all(np.isfinite(r["ce"]) for r in out["rounds"])
    assert out["stage1_ms"] > 0


@pytest.mark.parametrize("layers", [1, 2])
def test_train_cli_dry_run_cuts_a_moe_stack_to_fit(layers, capsys):
    """``--layers`` reaches the launcher's dry run: mixtral-8x22b at full
    width, 2 clients in 1 cluster, counted on fake tensors at the depth
    given (chip_smoke's ``train_moe`` runs 1 layer; 2 fit the card): the
    argument bytes are the two clients' bf16 weights at that depth, and
    the depth is what sets the peak (about 27.6 GB a layer)."""
    import ast
    from repro_torch.launch import train as train_lib
    cfg = tconfigs.depth_cut(tconfigs.get_config("mixtral-8x22b"), layers)
    train_lib.main(["--arch", "mixtral-8x22b", "--dry-run", "--clients",
                    "2", "--clusters", "1", "--layers", str(layers)])
    mem = ast.literal_eval(capsys.readouterr().out.splitlines()[1])
    assert mem["argument_size_in_bytes"] == pytest.approx(
        2 * 2 * cfg.param_count(), rel=1e-3)
    assert 30e9 * layers < mem["total_hbm_bytes"] < 10e9 + 30e9 * layers


def test_stage1_plan_at_gemma2_2b_size():
    """The grouped stage-1 launch at the slice's size, planned on the CPU:
    gemma2-2b's 24 leaves over C = 4 clients, K = 2, bf16.  The embedding
    leaf stacks 2.36e9 elements (past 2^31: the kernel's offsets are 64-bit
    and P goes over as ``c_longlong``); C <= 8, so a thread sums all rows
    of its 16 bytes of columns, 2048 columns a block: one launch of ~1.28M
    blocks, the tile starts and the grid under 2^31, and one output buffer
    of K * sum(P) = 5.2e9 elements with each leaf's view at its
    offset."""
    import ctypes
    from repro_torch.kernels import weighted_agg as wagg
    cfg = dataclasses.replace(tconfigs.get_config("gemma2-2b"),
                              dtype="bfloat16")
    shapes = tuple(torch.Size((C,) + tuple(x.shape))
                   for x in tree_leaves(tsteps._param_structs(cfg)))
    assert len(shapes) == 24
    ps = [s.numel() // C for s in shapes]
    assert sum(ps) == 2_614_341_888 and C * max(ps) > 2**31
    pl, total, views, arrays = wagg._planned(shapes, K, torch.bfloat16,
                                             (True,) * len(shapes))
    assert pl.launches == 1 and pl.passes == 1 and pl.kmax == 4
    assert set(pl.vec) == {8} and pl.lanes == wagg.THREADS == 256
    assert pl.tiles == tuple(-(-p // 2048) for p in ps)
    assert pl.blocks == sum(pl.tiles) < 2**31
    assert 1_270_000 < pl.blocks < 1_290_000
    assert max(pl.first) + max(pl.tiles) <= pl.blocks
    assert total == K * sum(ps)
    offsets = [v[2] for v in views]
    assert offsets == [K * sum(ps[:i]) for i in range(len(ps))]
    ps_arr, first_arr, vec_arr, tiles = arrays[0]
    assert isinstance(ps_arr[0], int) and ps_arr._type_ is ctypes.c_longlong
    assert sorted(ps_arr) == sorted(ps) and tiles == pl.blocks
