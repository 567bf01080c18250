"""The port's mixture-of-experts layer (``repro_torch/models/moe.py``)
against ``repro.models.moe``, on the CPU, from the same numpy inputs and
the reference's own parameters carried across (``params_from_numpy``).

Tolerances, float32 on both sides (the two packages sum the same
products in other orders):
- ``router_probs``, ``load_balance_loss`` and each of the three
  dispatches (dense, capacity at the default factor 1.25, so tokens are
  dropped, and scan), output and aux loss: 1e-5;
- top-k indices exact, also where logits tie (the lower index first, as
  ``jax.lax.top_k``), and the capacity dispatch's dropped tokens the
  reference's;
- gradients through the capacity and scan dispatches (scan under
  ``torch.utils.checkpoint``): rtol 1e-5 and an atol of 1e-5 of the
  leaf's largest gradient;
- ``loss_fn`` (CE + 0.01 aux) of the smoke grok-1-314b and mixtral-8x22b
  under each dispatch, value and gradients: the same bars;
- the port's capacity dispatch equals its dense one when the capacity
  holds every token: 1e-5 (the reference's own test holds itself at
  2e-4).
- bfloat16 scan: the accumulator rounds to bf16 after each expert in
  expert order on both sides; output within two bf16 ulps (2^-7 relative)
  plus 2^-7 of its largest magnitude.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro_torch import configs as tconfigs
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.models.transformer import params_from_numpy
from repro_torch.tree import tree_leaves, tree_unflatten

torch.set_num_threads(1)        # see test_torch_jaxref.py
CPU = torch.device("cpu")
MOE_ARCHS = ("grok-1-314b", "mixtral-8x22b")


def _cfgs(arch="mixtral-8x22b"):
    return (jconfigs.smoke_variant(jconfigs.get_config(arch)),
            tconfigs.smoke_variant(tconfigs.get_config(arch)))


def _params(jc, seed, dtype=jnp.float32):
    jp = jmoe.init_moe(jc, jax.random.PRNGKey(seed), dtype)
    npp = jax.tree_util.tree_map(np.asarray, jp)
    return jax.tree_util.tree_map(jnp.asarray, npp), params_from_numpy(npp,
                                                                       CPU)


def _x(seed, shape, scale=0.5):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _close_grads(got, want, tol=1e-5):
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(
            g.numpy(), w, rtol=tol,
            atol=tol * max(float(np.abs(w).max()), 1e-30))


# ------------------------------------------------------------------ router

def test_top_k_orders_ties_as_lax_top_k():
    """Integer-valued logits, most rows with ties: values and indices
    equal to ``jax.lax.top_k``'s for every k."""
    logits = np.random.default_rng(0).integers(0, 3, (64, 8)).astype(
        np.float32)
    for k in (1, 2, 3, 8):
        wv, wi = jax.lax.top_k(jnp.asarray(logits), k)
        gv, gi = tmoe.top_k(torch.from_numpy(logits), k)
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


@pytest.mark.parametrize("tied", [False, True])
def test_router_probs_match_reference(tied):
    """Top-k weights, indices and the full softmax; ``tied`` duplicates
    router columns (expert 1 = expert 0, expert 3 = expert 2), so every
    token's logits hold two ties and the top-2 often splits one."""
    jc, tc = _cfgs()
    jp, tp = _params(jc, 0)
    if tied:
        r = np.asarray(jp["router"]).copy()
        r[:, 1], r[:, 3] = r[:, 0], r[:, 2]
        jp["router"], tp["router"] = jnp.asarray(r), torch.from_numpy(r)
    x = _x(1, (2, 24, jc.d_model))
    jw, ji, jprobs = jmoe.router_probs(jc, jp, jnp.asarray(x))
    tw, ti, tprobs = tmoe.router_probs(tc, tp, torch.from_numpy(x))
    logits = (torch.from_numpy(x) @ tp["router"]).numpy()
    n_ties = int((logits[..., 1] == logits[..., 0]).sum())
    assert n_ties == (48 if tied else 0)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tw, jw, 1e-5)
    _close(tprobs, jprobs, 1e-5)


def test_load_balance_loss_matches_reference():
    jc, tc = _cfgs()
    rng = np.random.default_rng(2)
    probs = rng.dirichlet(np.ones(jc.num_experts), (3, 20)).astype(
        np.float32)
    idx = np.argsort(-probs, -1)[..., :jc.experts_per_token].astype(np.int32)
    want = jmoe.load_balance_loss(jc, jnp.asarray(probs), jnp.asarray(idx))
    got = tmoe.load_balance_loss(tc, torch.from_numpy(probs),
                                 torch.from_numpy(idx))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("T", [1, 7, 24, 100])
def test_capacity_rows_match_reference(T):
    jc, tc = _cfgs()
    for factor in (0.5, 1.25, 4.0):
        want = min(int(math.ceil(T * jc.experts_per_token / jc.num_experts
                                 * factor)), T)
        assert tmoe.capacity(T, tc, factor) == want


# -------------------------------------------------------------- dispatches

@pytest.mark.parametrize("dispatch", ["dense", "capacity", "scan"])
@pytest.mark.parametrize("arch", MOE_ARCHS)             # gelu, silu
def test_dispatch_matches_reference(arch, dispatch):
    jc, tc = _cfgs(arch)
    jp, tp = _params(jc, 3)
    x = _x(4, (2, 40, jc.d_model))
    jy, jaux = jmoe.apply_moe(jc, jp, jnp.asarray(x), dispatch)
    ty, taux = tmoe.apply_moe(tc, tp, torch.from_numpy(x), dispatch)
    assert ty.shape == x.shape and ty.dtype == torch.float32
    _close(ty, jy, 1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


def test_capacity_drops_the_reference_tokens():
    """A tight capacity (factor 0.5): the tokens whose output is 0 for an
    expert are the reference's; the rest meet it at 1e-5."""
    jc, tc = _cfgs()
    jp, tp = _params(jc, 5)
    x = _x(6, (1, 32, jc.d_model))
    jy, _ = jmoe.apply_moe_capacity(jc, jp, jnp.asarray(x), 0.5)
    ty, _ = tmoe.apply_moe_capacity(tc, tp, torch.from_numpy(x), 0.5)
    dropped = np.all(np.asarray(jy) == 0, -1)
    assert dropped.any()
    np.testing.assert_array_equal(np.all(ty.numpy() == 0, -1), dropped)
    _close(ty, jy, 1e-5)


def test_capacity_equals_dense_with_ample_capacity():
    _, tc = _cfgs()
    gen = torch.Generator().manual_seed(7)
    p = tmoe.init_moe(tc, gen, torch.float32, CPU)
    x = 0.5 * torch.randn((2, 16, tc.d_model), generator=gen)
    yd, auxd = tmoe.apply_moe_dense(tc, p, x)
    yc, auxc = tmoe.apply_moe_capacity(tc, p, x,
                                       capacity_factor=float(tc.num_experts))
    torch.testing.assert_close(yc, yd, rtol=1e-5, atol=1e-5)
    assert float(auxc) == float(auxd)


@pytest.mark.parametrize("dispatch", ["capacity", "scan"])
def test_dispatch_gradients_match_reference(dispatch):
    """d/dparams and d/dx of mean(y^2) + 0.01 aux, the reference's
    ``test_moe_grads_finite_*`` loss; the scan's experts run under
    ``torch.utils.checkpoint``."""
    jc, tc = _cfgs()
    jp, tp = _params(jc, 8)
    x = _x(9, (1, 16, jc.d_model), 0.3)

    def jloss(p, x):
        y, aux = jmoe.apply_moe(jc, p, x, dispatch)
        return jnp.mean(jnp.square(y)) + 0.01 * aux

    jl, (jg, jgx) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jp, jnp.asarray(x))
    leaves = [t.requires_grad_(True) for t in tree_leaves(tp)]
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = tmoe.apply_moe(tc, tree_unflatten(tp, leaves), tx, dispatch)
    tl = y.square().mean() + 0.01 * aux
    grads = torch.autograd.grad(tl, leaves + [tx])
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    _close_grads(tree_unflatten(tp, list(grads[:-1])), jg)
    _close_grads((grads[-1],), (jgx,))


def test_scan_bf16_rounds_as_reference():
    jc, tc = _cfgs()
    jp, tp = _params(jc, 10, jnp.bfloat16)
    x = _x(11, (2, 24, jc.d_model))
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(x).bfloat16()
    jy, jaux = jmoe.apply_moe_scan(jc, jp, jx)
    ty, taux = tmoe.apply_moe_scan(tc, tp, tx)
    assert ty.dtype == torch.bfloat16
    w = np.asarray(jy, np.float32)
    np.testing.assert_allclose(ty.float().numpy(), w, rtol=2 ** -7,
                               atol=2 ** -7 * float(np.abs(w).max()))
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-3)


# ------------------------------------------- the experts' weight stacks

STACKS = ("w_gate", "w_up", "w_down")


def _stack_consumers(root, p):
    """For each expert stack of ``p`` (a leaf), the names of the backward
    nodes that take it as input, from a walk of ``root``'s graph."""
    names = {id(p[k]): k for k in STACKS}
    found = {k: [] for k in STACKS}
    seen, todo = set(), [root.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        for nxt, _ in node.next_functions:
            leaf = getattr(nxt, "variable", None)
            if leaf is not None and id(leaf) in names:
                found[names[id(leaf)]].append(type(node).__name__)
            todo.append(nxt)
    return found


def _scan_by_selects(cfg, p, x, tp=None):
    """The scan dispatch on one device with a select ``w[e]`` of each
    stack an expert, outside the expert's checkpoint: the same router,
    products, checkpoints and accumulator in the same order."""
    top_w, top_idx, probs = tmoe.router_probs(cfg, p, x)
    combine = (torch.nn.functional.one_hot(top_idx.long(), cfg.num_experts)
               .float() * top_w[..., None]).sum(-2)
    acc = torch.zeros_like(x)
    for e in range(cfg.num_experts):
        acc = acc + torch.utils.checkpoint.checkpoint(
            tmoe._expert, cfg, None, x, p["w_gate"][e], p["w_up"][e],
            p["w_down"][e], combine[..., e], use_reentrant=False).to(
                acc.dtype)
    return acc, tmoe.load_balance_loss(cfg, probs, top_idx)


def _experts_by_selects(cfg, p, xs, tp):
    """``moe._experts``' FSDP path, one expert after another, with a
    select ``w[e]`` of each stack and ``xs[e]`` an expert."""
    return torch.stack([torch.utils.checkpoint.checkpoint(
        tmoe._expert, cfg, tp, xs[e], p["w_gate"][e], p["w_up"][e],
        p["w_down"][e], use_reentrant=False)
        for e in range(cfg.num_experts)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("dispatch", ["scan", "dense-fsdp", "capacity-fsdp"])
def test_experts_unbind_each_stack_once_with_gradients_of_selects(
        monkeypatch, dispatch, dtype):
    """Under autograd each expert stack reaches the graph through one
    ``UnbindBackward`` and no select, and every gradient (the stacks', the
    router's, x's) and the loss are bit for bit those of the per-expert
    selects ``w[e]``: a select's gradient is the slice padded with zeros,
    so the sum of the E of them is the stacked slices exactly.  The scan
    on one device; the dense and capacity dispatches under FSDP (a "data"
    size of 2 whose gather stacks the block twice, in one process: their
    ``_experts`` runs an expert at a time), against ``_experts`` with
    selects."""
    from repro_torch.sharding import parallel as P
    _, cfg = _cfgs()
    d = cfg.d_model
    gen = torch.Generator().manual_seed(14)
    full = tmoe.init_moe(cfg, gen, dtype, CPU)
    x0 = (0.5 * torch.randn((2, 16, d), generator=gen)).to(dtype)
    if dispatch == "scan":
        tp, p0, apply, by_selects = None, full, tmoe.apply_moe_scan, \
            _scan_by_selects
    else:
        def gather(tp, w, dim, n):
            return w if w.shape[dim] == n else torch.cat([w, w], dim)
        monkeypatch.setattr(tmoe.P, "fsdp_gather", gather)
        tp = P.TP(group=None, size=1, rank=0, data_size=2)
        p0 = {"router": full["router"][: d // 2],
              "w_gate": full["w_gate"][:, : d // 2],
              "w_up": full["w_up"][:, : d // 2],
              "w_down": full["w_down"][..., : d // 2]}
        apply = (tmoe.apply_moe_dense if dispatch == "dense-fsdp"
                 else tmoe.apply_moe_capacity)

        def by_selects(cfg, p, x, tp):
            with monkeypatch.context() as m:
                m.setattr(tmoe, "_experts", _experts_by_selects)
                return apply(cfg, p, x, tp=tp)

    def run(fn):
        p = {k: v.detach().clone().requires_grad_(True)
             for k, v in p0.items()}
        x = x0.clone().requires_grad_(True)
        y, aux = fn(cfg, p, x, tp=tp)
        loss = y.float().square().mean() + 0.01 * aux
        return loss, _stack_consumers(loss, p), torch.autograd.grad(
            loss, list(p.values()) + [x])

    loss, consumers, grads = run(apply)
    want_loss, want_consumers, want = run(by_selects)
    assert consumers == {k: ["UnbindBackward0"] for k in STACKS}
    assert want_consumers == {k: ["SelectBackward0"] * cfg.num_experts
                              for k in STACKS}
    assert torch.equal(loss, want_loss)
    for name, g, w in zip(list(p0) + ["x"], grads, want):
        assert g.dtype == dtype and torch.equal(g, w), name


# -------------------------------------------------------------- loss_fn

@pytest.mark.parametrize("dispatch", ["dense", "capacity", "scan"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_loss_fn_value_and_gradients_match_reference(arch, dispatch):
    """The smoke grok-1-314b and mixtral-8x22b through ``loss_fn`` (CE +
    0.01 x the load-balance losses summed over layers), remat on: value,
    the aux metric, and every parameter's gradient."""
    jc, tc = _cfgs(arch)
    jp = jmodel.init_params(jc, jax.random.PRNGKey(12))
    toks = np.random.default_rng(13).integers(0, jc.vocab_size, (2, 33)
                                              ).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks[:, :-1]),
          "labels": jnp.asarray(toks[:, 1:])}
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jmodel.loss_fn(jc, p, jb, dispatch=dispatch, remat=True),
        has_aux=True)(jp)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), CPU)
    leaves = [t.requires_grad_(True) for t in tree_leaves(tp)]
    tb = {"tokens": torch.from_numpy(toks[:, :-1]).long(),
          "labels": torch.from_numpy(toks[:, 1:]).long()}
    tl, tm = tmodel.loss_fn(tc, tree_unflatten(tp, leaves), tb,
                            dispatch=dispatch, remat=True)
    assert float(tm["aux"].detach()) > 0
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    for key in ("aux", "ce"):
        np.testing.assert_allclose(float(tm[key].detach()), float(jm[key]),
                                   rtol=1e-5)
    grads = torch.autograd.grad(tl, leaves)
    got = tree_unflatten(tp, list(grads))
    want = jax.tree_util.tree_map(np.asarray, jg)
    _close_grads(got, want)          # both trees have the reference's order
