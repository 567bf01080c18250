"""Shared transformer building blocks: norms, embeddings, RoPE, gated MLP,
soft-cap.  Counterpart of ``repro/models/layers.py``.

Functional, as the reference: ``init_*`` returns a parameter tree (nested
dicts of tensors, the reference's key names), the ``apply`` functions are
pure.  Initialization draws from an explicit ``torch.Generator`` and may
stack a leading ``lead`` shape (the transformer's cycle dimension); its
numbers differ from the reference's ``jax.random`` streams, so parity tests
carry the reference's parameters across (`models/transformer.py::
params_from_numpy`).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.sharding import parallel as P


def _init(gen: torch.Generator, shape: Tuple[int, ...], scale: float,
          dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, device=gen.device).mul_(scale)
    return x.to(device=device, dtype=dtype)


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------

def init_norm(cfg, dtype, device, lead=()) -> dict:
    return {"scale": torch.zeros(tuple(lead) + (cfg.d_model,), dtype=dtype,
                                 device=device)}


def apply_norm(cfg, p, x):
    if cfg.norm == "layernorm":
        mu = x.mean(-1, keepdim=True)
        var = x.var(-1, keepdim=True, unbiased=False)
        y = (x - mu) * torch.rsqrt(var + 1e-6)
    else:  # rmsnorm
        var = x.float().square().mean(-1, keepdim=True)
        y = x * torch.rsqrt(var + 1e-6).to(x.dtype)
    return y * (1.0 + p["scale"].to(x.dtype))


# --------------------------------------------------------------------------
# Embedding / unembedding
# --------------------------------------------------------------------------

def init_embed(cfg, gen, dtype, device) -> dict:
    """Embedding table at ``vocab_padded`` rows; ``unembed`` masks the
    padded rows' logits."""
    s = 1.0 / math.sqrt(cfg.d_model)
    p = {"embedding": _init(gen, (cfg.vocab_padded, cfg.d_model), s, dtype,
                            device)}
    if not cfg.tie_embeddings:
        p["unembed"] = _init(gen, (cfg.d_model, cfg.vocab_padded), s, dtype,
                             device)
    return p


def embed_tokens(cfg, p, tokens, tp=None):
    """Token embeddings.  Under tensor parallelism (``tp``, a
    `sharding/parallel.TP`) a vocab-sharded table looks up the tokens in
    its rows, zeroes the others and all-reduces over "model" (one nonzero
    term a token: the sum is exact); an FSDP table is gathered first."""
    table = P.fsdp_gather(tp, p["embedding"], 1, cfg.d_model)
    lo, hi = P.vocab_range(tp, table.shape[0], cfg.vocab_padded)
    if hi - lo == cfg.vocab_padded:
        x = table[tokens]
    else:
        local = tokens - lo
        inside = ((local >= 0) & (local < hi - lo))[..., None]
        x = table[local.clamp(0, hi - lo - 1)].masked_fill(~inside, 0)
        x = P.reduce_from_model(tp, x)
    if cfg.name.startswith("gemma") or cfg.name.startswith("recurrentgemma"):
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def unembed(cfg, p, x, tp=None):
    """Logits over the padded vocab; padded entries are masked to -1e30.
    A vocab-sharded table (``tp``) gives this rank's slice of the logits,
    (..., V_padded / model), the padded entries found by their global
    index."""
    if cfg.tie_embeddings:
        w = P.fsdp_gather(tp, p["embedding"], 1, cfg.d_model).T
    else:
        w = P.fsdp_gather(tp, p["unembed"], 0, cfg.d_model)
    lo, hi = P.vocab_range(tp, w.shape[1], cfg.vocab_padded)
    if hi - lo != cfg.vocab_padded:
        x = P.copy_to_model(tp, x)
    logits = x @ w
    if cfg.final_softcap:
        logits = softcap(logits, cfg.final_softcap)
    if cfg.vocab_padded != cfg.vocab_size:
        pad = torch.arange(lo, hi, device=x.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    return logits


def softcap(x, cap: float):
    c = torch.tensor(cap, dtype=x.dtype)
    return c * torch.tanh(x / c)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------

def rope_frequencies(cfg, positions):
    """positions (..., S) int -> (sin, cos) of shape (..., S, head_dim/2)."""
    half = cfg.head_dim // 2
    exponent = -torch.arange(0, half, dtype=torch.float32,
                             device=positions.device) / half
    freq = torch.pow(torch.full_like(exponent, cfg.rope_theta), exponent)
    ang = positions.float()[..., None] * freq
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x, sin, cos):
    """x (..., S, H, D); sin/cos (..., S, D/2) broadcast over heads."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    s = sin[..., :, None, :].to(x.dtype)
    c = cos[..., :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


# --------------------------------------------------------------------------
# Gated MLP
# --------------------------------------------------------------------------

def init_mlp(cfg, gen, dtype, device, lead=()) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    lead = tuple(lead)
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    return {
        "w_gate": _init(gen, lead + (d, f), s_in, dtype, device),
        "w_up": _init(gen, lead + (d, f), s_in, dtype, device),
        "w_down": _init(gen, lead + (f, d), s_out, dtype, device),
    }


def activation(cfg, x):
    if cfg.act == "gelu":
        return F.gelu(x, approximate="tanh")
    return F.silu(x)


def apply_mlp(cfg, p, x, tp=None):
    """The gated MLP.  Under tensor parallelism ``w_gate`` and ``w_up`` are
    column-parallel and ``w_down`` row-parallel (where d_ff divides), the
    output all-reduced over "model"; FSDP leaves are gathered at use."""
    d = cfg.d_model
    w_gate = P.fsdp_gather(tp, p["w_gate"], -2, d)
    w_up = P.fsdp_gather(tp, p["w_up"], -2, d)
    w_down = P.fsdp_gather(tp, p["w_down"], -1, d)
    split = P.is_split(w_gate.shape[-1], cfg.d_ff)
    if split:
        x = P.copy_to_model(tp, x)
    h = activation(cfg, x @ w_gate) * (x @ w_up)
    y = h @ w_down
    return P.reduce_from_model(tp, y) if split else y
