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
                  are recomputed in the backward pass.  The serving
                  profiles of grok-1-314b and mixtral-8x22b take it.

The reference computes all three in XLA, with no Pallas kernel, so here
they are torch ops; the expert products are ``torch.matmul``.

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


def router_probs(cfg, p, x) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Returns (top-k weights (.., k) f32, top-k indices (.., k), full
    probabilities (.., E) f32)."""
    logits = (x @ p["router"]).float()
    top_logits, top_idx = top_k(logits, cfg.experts_per_token)
    return (torch.softmax(top_logits, dim=-1), top_idx,
            torch.softmax(logits, dim=-1))


def load_balance_loss(cfg, probs, top_idx) -> torch.Tensor:
    """Switch-style auxiliary load-balance loss (mean probability x mean
    dispatch)."""
    e = cfg.num_experts
    dispatch = F.one_hot(top_idx.long(), e).float().sum(-2)
    frac_tokens = dispatch.reshape(-1, e).mean(0)
    frac_probs = probs.reshape(-1, e).mean(0)
    return e * (frac_tokens * frac_probs).sum()


def _expert_mlp(cfg, p, x):
    """x (E, C, d): each expert's gated MLP on its own rows."""
    h = activation(cfg, x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]


def apply_moe_dense(cfg, p, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense dispatch: all experts on all tokens (the oracle)."""
    B, S, d = x.shape
    T, E = B * S, cfg.num_experts
    top_w, top_idx, probs = router_probs(cfg, p, x)
    ye = _expert_mlp(cfg, p, x.reshape(1, T, d).expand(E, T, d))  # (E, T, d)
    combine = torch.zeros((T, E), dtype=torch.float32, device=x.device)
    combine.scatter_add_(1, top_idx.reshape(T, -1).long(),
                         top_w.reshape(T, -1))
    y = torch.einsum("te,etd->td", combine.to(x.dtype), ye)
    return y.reshape(B, S, d), load_balance_loss(cfg, probs, top_idx)


def capacity(T: int, cfg, capacity_factor: float = 1.25) -> int:
    """Rows an expert takes: ``min(ceil(T K / E * factor), T)``, in Python
    floats as the reference computes it."""
    E, K = cfg.num_experts, cfg.experts_per_token
    return min(int(math.ceil(T * K / E * capacity_factor)), T)


def apply_moe_capacity(cfg, p, x, capacity_factor: float = 1.25
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity dispatch: token slots sorted by expert (stable), each
    expert's first ``cap`` slots into a fixed (E, cap) buffer, the expert
    MLPs, then a scatter-add back with the router's weights.  A slot past
    its expert's capacity goes to an overflow row and contributes 0."""
    B, S, d = x.shape
    T = B * S
    E, K = cfg.num_experts, cfg.experts_per_token
    cap = capacity(T, cfg, capacity_factor)

    top_w, top_idx, probs = router_probs(cfg, p, x)
    aux = load_balance_loss(cfg, probs, top_idx)
    xt = x.reshape(T, d)
    flat_e = top_idx.reshape(T * K).long()            # expert of each slot
    flat_w = top_w.reshape(T * K)
    flat_t = torch.arange(T, device=x.device).repeat_interleave(K)

    order = torch.argsort(flat_e, stable=True)        # slots by expert
    e_sorted, t_sorted, w_sorted = flat_e[order], flat_t[order], flat_w[order]
    # rank of each slot within its expert's group
    rank = (torch.arange(T * K, device=x.device)
            - torch.searchsorted(e_sorted, e_sorted, side="left"))
    keep = rank < cap
    slot = torch.where(keep, e_sorted * cap + rank, E * cap)   # overflow row

    buf = torch.zeros((E * cap + 1, d), dtype=x.dtype, device=x.device)
    buf = buf.index_put((slot,), xt[t_sorted])
    ye = _expert_mlp(cfg, p, buf[:-1].reshape(E, cap, d)).reshape(E * cap, d)
    ye = torch.cat([ye, ye.new_zeros((1, d))], 0)

    contrib = ye[slot] * w_sorted[:, None].to(x.dtype)
    y = torch.zeros((T, d), dtype=x.dtype, device=x.device).index_add(
        0, t_sorted, torch.where(keep[:, None], contrib, 0))
    return y.reshape(B, S, d), aux


def _expert_out(cfg, x, wg, wu, wd, ce):
    """One expert on every token, weighted by its (B, S) routing weights
    ``ce`` (0 where the token is not routed to it)."""
    h = activation(cfg, x @ wg) * (x @ wu)
    return (h @ wd) * ce[..., None].to(x.dtype)


def apply_moe_scan(cfg, p, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scan-over-experts dispatch: the dense dispatch's numerics, one
    expert after another, so the live intermediate is one expert's
    activations.  The experts' E / k extra FLOP are the price of no
    sort or scatter."""
    top_w, top_idx, probs = router_probs(cfg, p, x)
    aux = load_balance_loss(cfg, probs, top_idx)
    # combine[b, s, e]: the routing weight (0 if unrouted), from a one-hot
    combine = (F.one_hot(top_idx.long(), cfg.num_experts).float()
               * top_w[..., None]).sum(-2)
    grad = torch.is_grad_enabled() and (
        x.requires_grad or p["w_gate"].requires_grad)
    acc = torch.zeros_like(x)
    for e in range(cfg.num_experts):
        args = (x, p["w_gate"][e], p["w_up"][e], p["w_down"][e],
                combine[..., e])
        if grad:
            out = torch.utils.checkpoint.checkpoint(
                _expert_out, cfg, *args, use_reentrant=False)
        else:
            out = _expert_out(cfg, *args)
        acc = acc + out
    return acc, aux


def apply_moe(cfg, p, x, dispatch: str = "dense"
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y (B, S, d) in x's dtype, the f32 load-balance loss)."""
    if dispatch == "capacity":
        return apply_moe_capacity(cfg, p, x)
    if dispatch == "scan":
        return apply_moe_scan(cfg, p, x)
    return apply_moe_dense(cfg, p, x)
