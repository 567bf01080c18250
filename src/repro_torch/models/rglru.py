"""RG-LRU recurrent block (RecurrentGemma / Griffin) [arXiv:2402.19427].
Counterpart of ``repro/models/rglru.py``.

Block structure (the "recurrent block" of Griffin):

    x -> linear_x (d -> w) -> causal conv (width 4) -> RG-LRU -> *
    x -> linear_gate (d -> w) -> gelu ----------------------------+-> linear_out

RG-LRU recurrence (per channel):
    r_t = sigmoid(W_a y_t + b_a)          recurrence gate
    i_t = sigmoid(W_x y_t + b_x)          input gate
    log a_t = -c * softplus(Lambda) * r_t
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * y_t)

Train and prefill scan the sequence in log depth (:func:`linear_scan`,
where the reference calls ``jax.lax.associative_scan``); decode is the
one-step recurrence.  Cache: {"h": (B, W) f32, "conv": (B, K-1, W)},
written in place by prefill and decode (see ``models/ssm.py``).

On a mesh (``tp``, `sharding/parallel.TP`) a rank holds its block of the
W channels (the reference's placement): ``w_x`` and ``w_gate`` are
column-parallel, the conv, the gates' biases, Lambda, the scan and the
caches run on the rank's channels, and ``w_out`` is row-parallel.  The
gates multiply the whole conv output by ``lru_wa``/``lru_wx``, whose
columns are the rank's: the conv output is gathered over "model" once a
layer (`parallel.gather_model`, in its own dtype; its backward a
reduce-scatter).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _init
from repro_torch.models.ssm import _filled, softplus
from repro_torch.sharding import parallel as P

_C = 8.0  # Griffin's fixed temperature


def init_rglru(cfg, gen, dtype, device, lead=()) -> dict:
    w = cfg.lru_width or cfg.d_model
    d = cfg.d_model
    lead = tuple(lead)
    s = 1.0 / math.sqrt(d)
    f32 = torch.float32
    return {
        "w_x": _init(gen, lead + (d, w), s, dtype, device),
        "w_gate": _init(gen, lead + (d, w), s, dtype, device),
        "conv_w": _init(gen, lead + (4, w), 0.5, dtype, device),
        "conv_b": torch.zeros(lead + (w,), dtype=dtype, device=device),
        "lru_wa": _init(gen, lead + (w, w), 1.0 / math.sqrt(w), dtype, device),
        "lru_wx": _init(gen, lead + (w, w), 1.0 / math.sqrt(w), dtype, device),
        "lru_ba": torch.zeros(lead + (w,), dtype=f32, device=device),
        "lru_bx": torch.zeros(lead + (w,), dtype=f32, device=device),
        # Lambda init so a^c in ~(0.9, 0.999)
        "lru_lambda": _filled(torch.linspace(0.3, 1.5, w, dtype=f32), lead,
                              device),
        "w_out": _init(gen, lead + (w, d), 1.0 / math.sqrt(w), dtype, device),
    }


def _conv(p, y, conv_state=None):
    K = p["conv_w"].shape[0]
    if conv_state is None:
        pad = y.new_zeros(y.shape[:1] + (K - 1,) + y.shape[2:])
    else:
        pad = conv_state.to(y.dtype)
    yp = torch.cat([pad, y], dim=1)
    S = y.shape[1]
    out = sum(yp[:, i:i + S] * p["conv_w"][i] for i in range(K))
    return out + p["conv_b"], yp[:, -(K - 1):]


def _lru_coeffs(p, y, tp=None):
    """Per-step (a_t, b_t) with h_t = a_t h_{t-1} + b_t, in float32 (the
    products with ``lru_wa``/``lru_wx`` too; TF32 is off, ``device.py``).
    With ``tp`` ``y`` is the rank's channels, gathered whole for the
    gates' products."""
    yf = y.float()
    yw = P.gather_model(tp, y, -1).float() if tp is not None else yf
    r = torch.sigmoid(yw @ p["lru_wa"].float() + p["lru_ba"])
    i = torch.sigmoid(yw @ p["lru_wx"].float() + p["lru_bx"])
    log_a = -_C * softplus(p["lru_lambda"]) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)
                       ) * (i * yf)
    return a, gated


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t over dim 1, from h_{-1} = 0: every h_t.

    A Hillis-Steele scan of the pairs (a, b) under the reference's combine
    ``(a1, b1), (a2, b2) -> (a1 a2, b1 a2 + b2)``: ceil(log2 S) rounds,
    round k combining each step with the one 2^k before it, out of place
    (autograd differentiates it).  It multiplies the a's directly, never
    through a cumulative product and a division, which would underflow
    over long sequences."""
    S = a.shape[1]
    d = 1
    while d < S:
        b = torch.cat([b[:, :d], b[:, :-d] * a[:, d:] + b[:, d:]], dim=1)
        if 2 * d < S:                     # the last round needs no a
            a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return b


def apply_rglru(cfg, p, x, *, mode: str, cache: Optional[dict] = None,
                tp=None) -> Tuple[torch.Tensor, Optional[dict]]:
    """x: (B,S,d) -> (B,S,d).  Returns (y, cache): in decode, and in
    prefill with a cache, the cache's tensors hold the new state.
    ``tp`` runs the block on this rank's channels (module docstring)
    where they are split over "model"."""
    if tp is None or not P.is_split(p["w_x"].shape[-1],
                                    cfg.lru_width or cfg.d_model):
        tp = None
    x = P.copy_to_model(tp, x)
    y = x @ p["w_x"]
    gate = F.gelu(x @ p["w_gate"], approximate="tanh")

    new_cache = None
    if mode == "decode":
        y, new_conv = _conv(p, y, cache["conv"])
        a, b = _lru_coeffs(p, y, tp)                    # (B,1,W)
        h = cache["h"][:, None] * a + b
        out = h
        cache["h"].copy_(h[:, 0])
        cache["conv"].copy_(new_conv)
        new_cache = cache
    else:
        y, conv_tail = _conv(p, y, None)
        a, b = _lru_coeffs(p, y, tp)                    # (B,S,W)
        out = linear_scan(a, b)
        if mode == "prefill" and cache is not None:
            cache["h"].copy_(out[:, -1])
            cache["conv"].copy_(conv_tail)
            new_cache = cache

    out = out.to(x.dtype) * gate
    return P.reduce_from_model(tp, out @ p["w_out"]), new_cache


def init_rglru_cache(cfg, batch: int, dtype, device, lead=(),
                     shards: int = 1) -> dict:
    """A layer's state, of a rank's channels where ``shards`` (the
    "model" size) divides the width (the reference's placement)."""
    w = cfg.lru_width or cfg.d_model
    if w % shards == 0:
        w //= shards
    lead = tuple(lead)
    return {"h": torch.zeros(lead + (batch, w), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros(lead + (batch, 3, w), dtype=dtype,
                                device=device)}


def rglru_reference(p, y):
    """Sequential oracle for the scan (tests): one step a token."""
    a, b = _lru_coeffs(p, y)
    h = torch.zeros(a.shape[:1] + a.shape[2:], dtype=torch.float32,
                    device=a.device)
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, 1)
