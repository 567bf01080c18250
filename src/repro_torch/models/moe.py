"""Mixture-of-experts layer (grok-1, mixtral): top-k router and gated-MLP
experts.  Counterpart of ``repro/models/moe.py``.

Three dispatches, as in the reference:

* ``dense``    -- every expert processes every token, combined with the
                  (sparse) router weights: the oracle of the tests.
* ``capacity`` -- tokens sorted by their expert, each expert a fixed
                  slice of ``min(ceil(T K / E * 1.25), T)`` rows; tokens
                  over capacity are dropped.
* ``scan``     -- every expert on every token, one expert after another
                  (the reference's ``lax.scan``), added into an
                  accumulator of the input's dtype in expert order, so
                  bf16 rounds as the reference's does.  Under autograd
                  each expert runs under ``torch.utils.checkpoint`` (the
                  reference's ``jax.checkpoint``): its hidden activations
                  are recomputed in the backward pass.  The experts'
                  weights are views from one ``unbind`` of each stack a
                  layer call, so backward builds each stack's gradient
                  once (one stacking of the E slices), not E zero-filled
                  gradients of the whole stack and their sum.  The
                  serving profiles of grok-1-314b and mixtral-8x22b take
                  it.

The reference computes all three in XLA, with no Pallas kernel, so here
they are torch ops; the expert products are ``torch.matmul``.

On a mesh (``tp``, `sharding/parallel.TP`) the reference's placement
holds: the experts dim replicated, each expert's ``w_gate``/``w_up`` (d,
f) and ``w_down`` (f, d) split on f over "model" and on d over "data"
under FSDP, the router (d, E) replicated over "model".  Every dispatch
runs the experts on the rank's f columns and all-reduces their combined
partial sums once a layer; the routing is the first rank's of each
"model" group.  Under FSDP every dispatch runs one expert at a time and
gathers that expert's blocks over "data" inside its checkpoint, never
the whole (E, d, f) stack.

Top-k: ``jax.lax.top_k`` puts the lower index first among equal values,
and the router's logits are cast to f32 from the model's dtype, so in
bf16 two experts often tie.  ``torch.topk`` promises no order among
equals, so :func:`router_probs` takes the first k of a stable descending
sort.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.models.layers import _init, activation
from repro_torch.obs.trace import grad_scope
from repro_torch.sharding import parallel as P


def _init_experts(gen, shape, scale, dtype, device) -> torch.Tensor:
    """``_init`` one (d, f) matrix at a time into the stacked leaf
    ``shape`` = lead + (E, d, f): a grok-1 expert stack over a few cycles
    holds 6.4e9 elements, whose float32 draw would not fit beside the rest
    of the model."""
    out = torch.empty(shape, dtype=dtype, device=device)
    flat = out.view(-1, *shape[-2:])
    for i in range(flat.shape[0]):
        flat[i] = _init(gen, tuple(shape[-2:]), scale, dtype, device)
    return out


def init_moe(cfg, gen, dtype, device, lead=()) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    lead = tuple(lead)
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    return {
        "router": _init(gen, lead + (d, e), s_in, dtype, device),
        "w_gate": _init_experts(gen, lead + (e, d, f), s_in, dtype, device),
        "w_up": _init_experts(gen, lead + (e, d, f), s_in, dtype, device),
        "w_down": _init_experts(gen, lead + (e, f, d), s_out, dtype, device),
    }


def top_k(logits: torch.Tensor, k: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest values in
    descending order, the lower index first among equals."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def router_probs(cfg, p, x, tp=None) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """Returns (top-k weights (.., k) f32, top-k indices (.., k), full
    probabilities (.., E) f32).  On a mesh (``tp``) the router is
    replicated over "model" (gathered over "data" under FSDP) and every
    rank of a "model" group routes its replicated ``x`` alike; the first
    rank's top-k indices are taken by all (`parallel.agree_over_model`),
    so that no bf16 tie resolves two ways, and the weights are the rank's
    own logits at them (the same values, still differentiable)."""
    router = P.fsdp_gather(tp, p["router"], -2, cfg.d_model)
    logits = (x @ router).float()
    top_logits, top_idx = top_k(logits, cfg.experts_per_token)
    if P.model_size(tp) > 1:
        top_idx = P.agree_over_model(tp, top_idx)
        top_logits = logits.gather(-1, top_idx)
    return (torch.softmax(top_logits, dim=-1), top_idx,
            torch.softmax(logits, dim=-1))


def load_balance_loss(cfg, probs, top_idx, tp=None) -> torch.Tensor:
    """Switch-style auxiliary load-balance loss (mean probability x mean
    dispatch).  Where the rows are split over "data"
    (``tp.rows_over_data``: a served batch, or each microbatch of a train
    step) the two means are the whole batch's, each rank's summed over
    "data"
    (`parallel.sum_over_data_both`: the gradient of the probabilities'
    mean reaches every rank's rows from every rank's loss)."""
    e = cfg.num_experts
    dispatch = F.one_hot(top_idx.long(), e).float().sum(-2)
    frac_tokens = dispatch.reshape(-1, e).mean(0)
    frac_probs = probs.reshape(-1, e).mean(0)
    if _rows_over_data(tp):
        both = P.sum_over_data_both(
            tp, torch.cat([frac_tokens, frac_probs])) / tp.data_size
        frac_tokens, frac_probs = both[:e], both[e:]
    return e * (frac_tokens * frac_probs).sum()


def _rows_over_data(tp) -> bool:
    """Whether this rank's rows are its block of a batch split over
    "data" (`parallel.TP.rows_over_data`)."""
    return tp is not None and tp.rows_over_data and tp.data_size > 1


def _expert_mlp(cfg, p, x):
    """x (E, C, d): each expert's gated MLP on its own rows."""
    h = activation(cfg, x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]


def _expert(cfg, tp, x, wg, wu, wd, ce=None):
    """One expert's gated MLP on the rows ``x``, weighted by its (..)
    routing weights ``ce`` (0 where a token is not routed to it) where
    given.  Under FSDP the expert's blocks are gathered over "data" here
    (the identity otherwise): under the expert's checkpoint the gather
    runs again in backward instead of the whole expert being kept."""
    d = cfg.d_model
    wg, wu = (P.fsdp_gather(tp, w, -2, d) for w in (wg, wu))
    wd = P.fsdp_gather(tp, wd, -1, d)
    y = (activation(cfg, x @ wg) * (x @ wu)) @ wd
    return y if ce is None else y * ce[..., None].to(x.dtype)


def _expert_weights(p):
    """Each expert's (w_gate, w_up, w_down), in expert order: views from
    one ``unbind`` of each (E, ..) stack.  Under autograd a stack's
    gradient then comes back through one ``UnbindBackward``, which stacks
    the experts' slice gradients once; a select ``w[e]`` an expert would
    instead give each expert a zero-filled gradient of the whole stack,
    added E - 1 times."""
    return zip(*(p[k].unbind(0) for k in ("w_gate", "w_up", "w_down")))


def _run_expert(cfg, tp, wg, wu, wd, x, ce=None):
    """:func:`_expert` with one expert's weights ``wg``, ``wu``, ``wd``
    (views from :func:`_expert_weights`) on ``x``, under
    ``torch.utils.checkpoint`` where autograd records (the reference's
    ``jax.checkpoint``: its hidden activations, and under FSDP its
    gathered blocks, are recomputed in the backward pass)."""
    args = (x, wg, wu, wd, ce)
    if torch.is_grad_enabled() and (x.requires_grad or wg.requires_grad):
        return torch.utils.checkpoint.checkpoint(
            _expert, cfg, tp, *args, use_reentrant=False)
    return _expert(cfg, tp, *args)


def _experts(cfg, p, xs, tp):
    """xs (E, C, d): each expert's gated MLP on its own rows, one batched
    product; under FSDP one expert after another
    (:func:`_run_expert`)."""
    if P.data_size(tp) == 1:
        return _expert_mlp(cfg, p, xs)
    return torch.stack([_run_expert(cfg, tp, *w, x)
                        for w, x in zip(_expert_weights(p), xs.unbind(0))])


def _on_mesh(tp) -> bool:
    return tp is not None and tp.active


def _split(cfg, p, tp) -> bool:
    """Whether the experts' f columns are split over "model" (per-expert
    TP: a rank's experts give partial sums)."""
    return _on_mesh(tp) and P.is_split(p["w_gate"].shape[-1], cfg.d_ff)


def apply_moe_dense(cfg, p, x, tp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense dispatch: all experts on all tokens (the oracle).  On a mesh
    each rank runs every expert on its f columns and the combined partial
    sums are all-reduced over "model" once."""
    B, S, d = x.shape
    T, E = B * S, cfg.num_experts
    top_w, top_idx, probs = router_probs(cfg, p, x, tp)
    combine = torch.zeros((T, E), dtype=torch.float32, device=x.device)
    combine.scatter_add_(1, top_idx.reshape(T, -1).long(),
                         top_w.reshape(T, -1))
    split = _split(cfg, p, tp)
    if split:
        x, combine = P.copy_to_model(tp, x), P.copy_to_model(tp, combine)
    ye = _experts(cfg, p, x.reshape(1, T, d).expand(E, T, d), tp)
    y = torch.einsum("te,etd->td", combine.to(x.dtype), ye)
    if split:
        y = P.reduce_from_model(tp, y)
    return y.reshape(B, S, d), load_balance_loss(cfg, probs, top_idx, tp)


def capacity(T: int, cfg, capacity_factor: float = 1.25) -> int:
    """Rows an expert takes: ``min(ceil(T K / E * factor), T)``, in Python
    floats as the reference computes it."""
    E, K = cfg.num_experts, cfg.experts_per_token
    return min(int(math.ceil(T * K / E * capacity_factor)), T)


def apply_moe_capacity(cfg, p, x, capacity_factor: float = 1.25, tp=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity dispatch: token slots sorted by expert (stable), each
    expert's first ``cap`` slots into a fixed (E, cap) buffer, the expert
    MLPs, then a scatter-add back with the router's weights.  A slot past
    its expert's capacity goes to an overflow row and contributes 0.  On a
    mesh every rank routes alike (the agreed indices), runs the experts
    on its f columns and all-reduces the scattered partial sums once.
    Where the rows are split over "data" (``tp.rows_over_data``; data
    rank r holds rows ``[r B, (r + 1) B)`` of the whole batch) the
    capacity and each slot's place in its expert are the whole batch's,
    as the reference's: the ranks' per-expert slot counts (E ints, no
    gradient) are all-gathered over "data", a slot's place is offset by
    the counts of the "data" ranks before it (the slots are in row-major
    order over the whole batch), and ``cap = capacity(T · data size)``."""
    B, S, d = x.shape
    T = B * S
    E, K = cfg.num_experts, cfg.experts_per_token
    over_data = _rows_over_data(tp)
    cap = capacity(T * (tp.data_size if over_data else 1), cfg,
                   capacity_factor)

    top_w, top_idx, probs = router_probs(cfg, p, x, tp)
    aux = load_balance_loss(cfg, probs, top_idx, tp)
    split = _split(cfg, p, tp)
    xt = (P.copy_to_model(tp, x) if split else x).reshape(T, d)
    flat_e = top_idx.reshape(T * K).long()            # expert of each slot
    flat_w = top_w.reshape(T * K)
    if split:
        flat_w = P.copy_to_model(tp, flat_w)
    flat_t = torch.arange(T, device=x.device).repeat_interleave(K)

    order = torch.argsort(flat_e, stable=True)        # slots by expert
    e_sorted, t_sorted, w_sorted = flat_e[order], flat_t[order], flat_w[order]
    # rank of each slot within its expert's group
    rank = (torch.arange(T * K, device=x.device)
            - torch.searchsorted(e_sorted, e_sorted, side="left"))
    if over_data:        # after the earlier "data" ranks' slots
        counts = torch.zeros(E, dtype=torch.int64, device=x.device)
        counts.index_add_(0, flat_e, torch.ones_like(flat_e))
        every = P.all_gather(counts, 0, tp.data_group, tp.data_size,
                             tp.data_rank, "data").view(tp.data_size, E)
        rank = rank + every[:tp.data_rank].sum(0)[e_sorted]
    keep = rank < cap
    slot = torch.where(keep, e_sorted * cap + rank, E * cap)   # overflow row

    buf = torch.zeros((E * cap + 1, d), dtype=x.dtype, device=x.device)
    buf = buf.index_put((slot,), xt[t_sorted])
    ye = _experts(cfg, p, buf[:-1].reshape(E, cap, d), tp).reshape(E * cap, d)
    ye = torch.cat([ye, ye.new_zeros((1, d))], 0)

    contrib = ye[slot] * w_sorted[:, None].to(x.dtype)
    y = torch.zeros((T, d), dtype=x.dtype, device=x.device).index_add(
        0, t_sorted, torch.where(keep[:, None], contrib, 0))
    if split:
        y = P.reduce_from_model(tp, y)
    return y.reshape(B, S, d), aux


def apply_moe_scan(cfg, p, x, tp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scan-over-experts dispatch: the dense dispatch's numerics, one
    expert after another (the reference's ``lax.scan``), so the live
    intermediate is one expert's activations.  The experts' E / k extra
    FLOP are the price of no sort or scatter.  On one device the experts
    add into an accumulator of x's dtype in expert order, so bf16 rounds
    as the reference's does.

    On a mesh (per-expert TP, the reference's placement) each expert is a
    column-parallel then row-parallel product on the rank's f columns: the
    rank's partial outputs, weighted by ``combine``, are summed over the
    experts in float32 and all-reduced over "model" once a layer, after
    the experts and outside their checkpoints (one B S d all-reduce, not
    one an expert).  ``x`` and ``combine`` enter through
    `parallel.copy_to_model`: their gradients from each rank's partial
    outputs are summed over "model", so the router's gradient is whole
    and the same on every rank.  The float32 sum rounds once where one
    device's bf16 accumulator rounds after every expert.  The loop over
    the experts is the ``moe/experts`` span (`obs/trace.grad_scope`, its
    backward and recompute included)."""
    top_w, top_idx, probs = router_probs(cfg, p, x, tp)
    aux = load_balance_loss(cfg, probs, top_idx, tp)
    # combine[b, s, e]: the routing weight (0 if unrouted), from a one-hot
    combine = (F.one_hot(top_idx.long(), cfg.num_experts).float()
               * top_w[..., None]).sum(-2)
    split = _split(cfg, p, tp)
    if split:
        x, combine = P.copy_to_model(tp, x), P.copy_to_model(tp, combine)

    def experts(x, combine):
        acc = torch.zeros(x.shape, device=x.device,
                          dtype=torch.float32 if _on_mesh(tp) else x.dtype)
        for w, ce in zip(_expert_weights(p), combine.unbind(-1)):
            acc = acc + _run_expert(cfg, tp, *w, x, ce).to(acc.dtype)
        return acc.to(x.dtype)

    y = grad_scope("moe/experts", experts, x, combine)
    return (P.reduce_from_model(tp, y) if split else y), aux


def apply_moe(cfg, p, x, dispatch: str = "dense", tp=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y (B, S, d) in x's dtype, the f32 load-balance loss).  ``tp``
    runs the mesh program (`sharding/parallel.TP`)."""
    if dispatch == "capacity":
        return apply_moe_capacity(cfg, p, x, tp=tp)
    if dispatch == "scan":
        return apply_moe_scan(cfg, p, x, tp=tp)
    return apply_moe_dense(cfg, p, x, tp=tp)
