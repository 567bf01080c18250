"""Mamba-2 SSD (state-space duality) block [arXiv:2405.21060].
Counterpart of ``repro/models/ssm.py``.

Train/prefill path: the chunked SSD algorithm (an intra-chunk term
quadratic in the chunk length, plus a linear recurrence over chunk states,
a Python loop over the chunks where the reference scans).  Decode path:
the exact one-step recurrence on the (B, H, P, N) state.  The SSD core
runs in float32, as the reference's; its output is cast to the input's
dtype before the gated norm.

Cache layout per SSD layer::

    {"h": (B, H, P, N) f32, "conv": (B, K-1, d_inner + 2N)}

Unlike the reference, which returns new cache arrays, prefill and decode
write the new state into the cache tensors they are handed (``copy_``):
the transformer stack hands each layer views of its stacked caches.

On a mesh (``tp``, `sharding/parallel.TP`) a rank holds its heads of the
layer, cut part by part (`sharding/rules.py`): its heads' z, x and dt
columns of ``in_proj`` and all of B and C, its x channels of the conv
and all of B and C, its heads of ``A_log``, ``D``, ``dt_bias``, its
channels of ``norm_scale`` and its rows of ``out_proj``; every width is
read from the rank's tensors.  The input enters through
`parallel.copy_to_model`; B and C feed every rank's heads, so their
weights (``in_proj``'s B and C columns, the conv's B and C channels) pass
through it too, their gradients summed over "model"; the gated norm's
sum of squares is summed over "model" both ways; ``out_proj`` is
row-parallel.  The caches hold the rank's heads and conv channels.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _init
from repro_torch.sharding import parallel as P

NEG_INF = -1e30


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)``, with no
    threshold (``F.softplus`` returns x above 20)."""
    return torch.logaddexp(x, x.new_zeros(()))


def _filled(value: torch.Tensor, lead, device) -> torch.Tensor:
    """``value`` repeated over a leading ``lead`` shape, on ``device``."""
    value = value.to(device)
    return value.expand(tuple(lead) + tuple(value.shape)).clone()


def init_ssd(cfg, gen, dtype, device, lead=()) -> dict:
    d, di, ns, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_ch = di + 2 * ns
    lead = tuple(lead)
    s = 1.0 / math.sqrt(d)
    f32 = torch.float32
    return {
        "in_proj": _init(gen, lead + (d, 2 * di + 2 * ns + nh), s, dtype,
                         device),
        "conv_w": _init(gen, lead + (cfg.ssm_conv, conv_ch),
                        1.0 / math.sqrt(cfg.ssm_conv), dtype, device),
        "conv_b": torch.zeros(lead + (conv_ch,), dtype=dtype, device=device),
        "A_log": _filled(torch.linspace(1.0, 16.0, nh, dtype=f32).log(),
                         lead, device),
        "D": torch.ones(lead + (nh,), dtype=f32, device=device),
        "dt_bias": torch.zeros(lead + (nh,), dtype=f32, device=device),
        "norm_scale": torch.zeros(lead + (di,), dtype=dtype, device=device),
        "out_proj": _init(gen, lead + (di, d), 1.0 / math.sqrt(di), dtype,
                          device),
    }


def _gated_rmsnorm(y, z, scale, tp=None, d_inner: int = 0):
    """The gated RMS norm over d_inner channels; with ``tp`` the rank's
    channels, their f32 sum of squares summed over "model" (both ways)
    and divided by the whole ``d_inner``."""
    y = y * F.silu(z)
    if tp is None:
        var = y.float().square().mean(-1, keepdim=True)
    else:
        var = P.sum_over_model_both(
            tp, y.float().square().sum(-1, keepdim=True)) / d_inner
    return (y * torch.rsqrt(var + 1e-6).to(y.dtype)) * (1.0 + scale.to(y.dtype))


def _split_proj(di: int, ns: int, zxbcdt):
    """(z, xBC, dt) of the projection, ``di`` channels of z and x."""
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di:2 * di + 2 * ns]
    dt = zxbcdt[..., 2 * di + 2 * ns:]
    return z, xBC, dt


def _bc_summed(tp, w, lo: int, hi: int):
    """``w`` with its B and C columns ``[lo, hi)`` (last dim) through
    `parallel.copy_to_model`: every rank's heads read them, so their
    gradient is the sum over "model".  Without autograd, ``w``."""
    if not (torch.is_grad_enabled() and w.requires_grad):
        return w
    return torch.cat([w[..., :lo], P.copy_to_model(tp, w[..., lo:hi]),
                      w[..., hi:]], -1)


def _causal_conv(cfg, p, xBC, conv_state=None):
    """Depthwise causal conv, width K.  conv_state: (B, K-1, C) history."""
    K = cfg.ssm_conv
    if conv_state is None:
        pad = xBC.new_zeros(xBC.shape[:1] + (K - 1,) + xBC.shape[2:])
    else:
        pad = conv_state.to(xBC.dtype)
    xp = torch.cat([pad, xBC], dim=1)                   # (B, S+K-1, C)
    S = xBC.shape[1]
    out = sum(xp[:, i:i + S] * p["conv_w"][i] for i in range(K))
    out = F.silu(out + p["conv_b"])
    new_state = xp[:, -(K - 1):] if K > 1 else pad[:, :0]
    return out, new_state


def _ssd_chunked(cfg, x, dt, B_mat, C_mat, A, h0=None):
    """Chunked SSD scan.

    x: (B,S,H,P); dt: (B,S,H) (post-softplus); B_mat/C_mat: (B,S,N);
    A: (H,) negative; h0: (B,H,P,N) or None.  Returns (y (B,S,H,P),
    h_final (B,H,P,N)), in float32.

    The reference's three multi-operand einsums are two-operand products
    here, in this order: y_intra = (C B^T * L) @ (dt x) over the chunk's
    keys, the decay matrix laid out (B, nc, H, Q, Q); states = B^T @
    (decay_out dt x) over the chunk, laid out (B, nc, N, H, P); y_inter =
    (C @ h_prev) * exp(cum).  No intermediate grows past (B, nc, H, Q, Q).
    """
    Bb, S, H, P = x.shape
    N = B_mat.shape[-1]
    Q = min(cfg.ssm_chunk, S)
    pad = (-S) % Q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B_mat = F.pad(B_mat, (0, 0, 0, pad))
        C_mat = F.pad(C_mat, (0, 0, 0, pad))
    nc = x.shape[1] // Q

    xc = x.reshape(Bb, nc, Q, H, P).float()
    dtc = dt.reshape(Bb, nc, Q, H).float()
    Bc = B_mat.reshape(Bb, nc, Q, N).float()
    Cc = C_mat.reshape(Bb, nc, Q, N).float()

    dA = dtc * A                                        # (B,nc,Q,H) negative
    cum = torch.cumsum(dA, dim=2)                       # within-chunk cumsum

    # intra-chunk (quadratic in Q): L[i,j] = exp(cum_i - cum_j), i >= j
    cum_h = cum.transpose(2, 3)                         # (B,nc,H,Q)
    li = cum_h[..., :, None] - cum_h[..., None, :]      # (B,nc,H,Q,Q)
    mask = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    # mask BEFORE exp: exp of the (positive) upper-triangular entries would
    # overflow and poison gradients through the where.
    L = torch.exp(torch.where(mask, li, NEG_INF))
    G = Cc @ Bc.transpose(-1, -2)                       # (B,nc,Q,Q)
    M = G[:, :, None] * L                               # (B,nc,H,Q,Q)
    dtx = dtc[..., None] * xc                           # (B,nc,Q,H,P)
    y_intra = (M @ dtx.transpose(2, 3)).transpose(2, 3)  # (B,nc,Q,H,P)

    # chunk states: S_k = sum_j exp(cum_last - cum_j) dt_j B_j x_j
    decay_out = torch.exp(cum[:, :, -1:, :] - cum)      # (B,nc,Q,H)
    u = decay_out[..., None] * dtx                      # (B,nc,Q,H,P)
    states = (Bc.transpose(-1, -2) @ u.reshape(Bb, nc, Q, H * P)
              ).reshape(Bb, nc, N, H, P)
    chunk_decay = torch.exp(cum[:, :, -1, :])           # (B,nc,H)

    h = (torch.zeros((Bb, N, H, P), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float().permute(0, 3, 1, 2))  # (B,N,H,P)
    h_prev = []                                         # PRE-chunk states
    for c in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, c, None, :, None] + states[:, c]
    h_prev = torch.stack(h_prev, 1)                     # (B,nc,N,H,P)

    # inter-chunk: y_i += C_i . (exp(cum_i) * h_prev)
    y_inter = (Cc @ h_prev.reshape(Bb, nc, N, H * P)).reshape(
        Bb, nc, Q, H, P) * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(Bb, nc * Q, H, P)[:, :S]
    return y, h.permute(0, 2, 3, 1)                     # (B,H,P,N)


def apply_ssd(cfg, p, x, *, mode: str, cache: Optional[dict] = None,
              tp=None) -> Tuple[torch.Tensor, Optional[dict]]:
    """One Mamba-2 block.  x: (B,S,d).  Returns (y, cache): in decode, and
    in prefill with a cache, the cache's tensors hold the new state.
    ``tp`` runs the block on this rank's heads (module docstring) where
    its heads are split over "model"."""
    Bb, S, d = x.shape
    ns, hd = cfg.ssm_state, cfg.ssm_head_dim
    nh = p["A_log"].shape[-1]                           # the rank's heads
    di = nh * hd
    if tp is None or not P.is_split(nh, cfg.ssm_heads):
        tp = None
    w_in, conv = p["in_proj"], p
    if tp is not None:
        x = P.copy_to_model(tp, x)
        w_in = _bc_summed(tp, w_in, 2 * di, 2 * di + 2 * ns)
        conv = {k: _bc_summed(tp, p[k], di, di + 2 * ns)
                for k in ("conv_w", "conv_b")}
    zxbcdt = x @ w_in
    z, xBC, dt = _split_proj(di, ns, zxbcdt)
    A = -torch.exp(p["A_log"])                          # (H,) negative
    dt = softplus(dt.float() + p["dt_bias"])

    new_cache = None
    if mode == "decode":
        xBC, new_conv = _causal_conv(cfg, conv, xBC, cache["conv"])
        xs = xBC[..., :di].reshape(Bb, S, nh, hd)
        B_mat = xBC[..., di:di + ns]
        C_mat = xBC[..., di + ns:]
        # exact recurrence, S == 1
        x0 = xs[:, 0].float()                           # (B,H,P)
        dA = torch.exp(dt[:, 0] * A)                    # (B,H)
        dBx = ((dt[:, 0, :, None] * x0)[..., None]
               * B_mat[:, 0].float()[:, None, None, :])  # (B,H,P,N)
        h_new = cache["h"] * dA[..., None, None] + dBx
        y = torch.einsum("bhpn,bn->bhp", h_new, C_mat[:, 0].float())
        y = y + p["D"][:, None] * x0
        y = y.reshape(Bb, 1, di).to(x.dtype)
        cache["h"].copy_(h_new)
        cache["conv"].copy_(new_conv)
        new_cache = cache
    else:
        xBC, conv_tail = _causal_conv(cfg, conv, xBC, None)
        xs = xBC[..., :di].reshape(Bb, S, nh, hd)
        B_mat = xBC[..., di:di + ns]
        C_mat = xBC[..., di + ns:]
        y, h_last = _ssd_chunked(cfg, xs, dt, B_mat, C_mat, A)
        y = y + p["D"][None, None, :, None] * xs.float()
        y = y.reshape(Bb, S, di).to(x.dtype)
        if mode == "prefill" and cache is not None:
            cache["h"].copy_(h_last)
            cache["conv"].copy_(conv_tail)
            new_cache = cache

    y = _gated_rmsnorm(y, z, p["norm_scale"], tp, cfg.d_inner)
    return P.reduce_from_model(tp, y @ p["out_proj"]), new_cache


def init_ssd_cache(cfg, batch: int, dtype, device, lead=(),
                   shards: int = 1) -> dict:
    """A layer's state, of a rank's heads where ``shards`` (the "model"
    size) divides them (`sharding/rules.py`'s cut)."""
    ns, hd, nh = cfg.ssm_state, cfg.ssm_head_dim, cfg.ssm_heads
    if nh % shards == 0:
        nh //= shards
    di = nh * hd
    lead = tuple(lead)
    return {
        "h": torch.zeros(lead + (batch, nh, hd, ns), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros(lead + (batch, cfg.ssm_conv - 1, di + 2 * ns),
                            dtype=dtype, device=device),
    }


def ssd_reference(cfg, x, dt, B_mat, C_mat, A, D):
    """Sequential oracle for tests: the plain recurrence, one step a
    token.  Returns (y (B,S,H,P), h (B,H,P,N)), in float32."""
    Bb, S, H, P = x.shape
    x, dt = x.float(), dt.float()
    B_mat, C_mat = B_mat.float(), C_mat.float()
    h = torch.zeros((Bb, H, P, B_mat.shape[-1]), dtype=torch.float32,
                    device=x.device)
    ys = []
    for t in range(S):
        x_t, dt_t = x[:, t], dt[:, t]
        dA = torch.exp(dt_t * A)                        # (B,H)
        h = h * dA[..., None, None] + ((dt_t[..., None] * x_t)[..., None]
                                       * B_mat[:, t, None, None, :])
        ys.append(torch.einsum("bhpn,bn->bhp", h, C_mat[:, t])
                  + D[:, None] * x_t)
    return torch.stack(ys, 1), h
