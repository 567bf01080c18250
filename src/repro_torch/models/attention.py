"""GQA attention with sliding windows, logit soft-capping, QKV bias and
ring-buffer KV caches.  Counterpart of ``repro/models/attention.py``.

Train and prefill self-attention go through ``kernels.ops.flash_attention``:
the hand-written CUDA kernel on the card, its plain PyTorch version
(``kernels/ref.py::flash_attention_ref``) on the CPU.  The reference spells
the same function twice in portable jnp, ``chunk_attention`` (a chunked
online softmax) and ``windowed_full_attention`` (its linear-cost form for
sliding windows), and keeps its Pallas kernel beside them; in the port the
kernel and its plain version take both places.  In prefill the positions
are ``arange(S)`` and Sq == Sk, which is the kernel's contract
(``q_pos = Sk - Sq + i``).  Decode attends over the ring-buffer cache with a
``slot_pos`` mask, outside that contract, so ``direct_attention`` computes
it in plain PyTorch (float32), as the reference computes it in one einsum.

Cache layout per attention layer::

    {"k": (B, L, Hkv, D), "v": (B, L, Hkv, D), "slot_pos": (L,) int32}

``slot_pos[s]`` is the absolute position held in slot ``s`` (-1 = empty).
Sliding-window layers use L = window_size as a ring buffer (slot = pos % L);
full-attention layers use L = max sequence length.  Unlike the reference,
whose arrays are immutable, the port writes prefill and decode results into
the cache tensors in place (the caller's dict is updated and returned), so a
decode step does not copy a 26-layer cache.

Not in this slice: cross-attention (``kv_x``, enc-dec) and the int8 cache
(``quantized=True``), which raise ``NotImplementedError``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.configs.shapes import effective_cache_len
from repro_torch.kernels import ops
from repro_torch.models.layers import _init, apply_rope, rope_frequencies, softcap

NEG_INF = -1e30


def init_attention(cfg, gen, dtype, device, lead=()) -> dict:
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    lead = tuple(lead)
    s = 1.0 / math.sqrt(d)
    p = {
        "wq": _init(gen, lead + (d, qd), s, dtype, device),
        "wk": _init(gen, lead + (d, kvd), s, dtype, device),
        "wv": _init(gen, lead + (d, kvd), s, dtype, device),
        "wo": _init(gen, lead + (qd, d), 1.0 / math.sqrt(qd), dtype, device),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", qd), ("bk", kvd), ("bv", kvd)):
            p[name] = torch.zeros(lead + (n,), dtype=dtype, device=device)
    return p


def _project_q(cfg, p, x):
    q = x @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    B, S = x.shape[:2]
    return q.reshape(B, S, cfg.num_heads, cfg.head_dim)


def _project_kv(cfg, p, x):
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    B, S = x.shape[:2]
    k = k.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    return k, v


def direct_attention(cfg, q, k, v, q_pos, k_pos, *, causal: bool,
                     window: int = 0):
    """Unchunked attention for tiny Sq (decode): one contraction over the
    whole cache, in float32.  q (B, Sq, Hq, D), k/v (B, L, Hkv, D), q_pos
    (Sq,), k_pos (L,); entries with k_pos < 0 are masked (empty slots)."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.float().reshape(B, Sq, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * (1.0 / math.sqrt(D))
    if cfg.attn_softcap:
        s = softcap(s, cfg.attn_softcap)
    mask = k_pos[None, :] >= 0
    if causal:
        mask = mask & (k_pos[None, :] <= q_pos[:, None])
    if window:
        mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
    s = s.masked_fill(~mask, NEG_INF)
    out = torch.einsum("bhgqk,bkhd->bqhgd", torch.softmax(s, dim=-1),
                       v.float())
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


# --------------------------------------------------------------------------
# Cache helpers
# --------------------------------------------------------------------------

def init_cache(cfg, kind: str, batch: int, max_len: int, dtype, device,
               quantized: bool = False, lead=()) -> dict:
    if quantized:
        raise NotImplementedError(
            "int8 KV cache: not in the port's serving slice (ROADMAP queue "
            "1, item 16, the rest of the transformer shelf)")
    L = effective_cache_len(cfg, kind, max_len)
    H, D = cfg.num_kv_heads, cfg.head_dim
    lead = tuple(lead)
    return {"k": torch.zeros(lead + (batch, L, H, D), dtype=dtype,
                             device=device),
            "v": torch.zeros(lead + (batch, L, H, D), dtype=dtype,
                             device=device),
            "slot_pos": torch.full(lead + (L,), -1, dtype=torch.int32,
                                   device=device)}


def _cache_write_decode(cache, k_new, v_new, pos: torch.Tensor):
    """Write one token (B, 1, Hkv, D) at ring slot pos % L, in place.
    ``pos`` is a (1,) tensor on the cache's device: no host sync."""
    slot = torch.remainder(pos, cache["k"].shape[1]).long()
    cache["k"].index_copy_(1, slot, k_new)
    cache["v"].index_copy_(1, slot, v_new)
    cache["slot_pos"].index_copy_(0, slot, pos.to(torch.int32))
    return cache


def cache_from_prefill(cache, k, v):
    """Fill a cache from full-sequence K/V (B, S, Hkv, D), ring-consistent,
    in place."""
    L = cache["k"].shape[1]
    S = k.shape[1]
    if L >= S:
        cache["k"][:, :S] = k
        cache["v"][:, :S] = v
        cache["slot_pos"][:S] = torch.arange(S, dtype=torch.int32,
                                             device=k.device)
        return cache
    # ring layout: position p lives at slot p % L, so the last L positions
    # [S - L, S) land at a roll of the tail
    shift = (S - L) % L
    cache["k"].copy_(torch.roll(k[:, S - L:], shift, dims=1))
    cache["v"].copy_(torch.roll(v[:, S - L:], shift, dims=1))
    cache["slot_pos"].copy_(torch.roll(
        torch.arange(S - L, S, dtype=torch.int32, device=k.device), shift))
    return cache


# --------------------------------------------------------------------------
# Full layer application
# --------------------------------------------------------------------------

def apply_attention(cfg, p, x, *, kind: str, mode: str,
                    positions: torch.Tensor, cache: Optional[dict] = None,
                    kv_x: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Optional[dict]]:
    """One causal self-attention layer.  mode: "train" | "prefill" |
    "decode"; ``positions`` is (S,) absolute positions of x's tokens (in
    decode, one position).  Returns (y, cache), the cache updated in
    place."""
    if kv_x is not None:
        raise NotImplementedError(
            "cross-attention (enc-dec): not in the port's serving slice "
            "(ROADMAP queue 1, item 16, the rest of the transformer shelf)")
    window = cfg.window_size if kind in ("swa", "local") else 0
    q = _project_q(cfg, p, x)
    sin, cos = rope_frequencies(cfg, positions)
    q = apply_rope(q, sin, cos)
    k, v = _project_kv(cfg, p, x)
    k = apply_rope(k, sin, cos)

    if mode == "decode":
        new_cache = _cache_write_decode(cache, k, v, positions)
        out = direct_attention(cfg, q, new_cache["k"], new_cache["v"],
                               positions, new_cache["slot_pos"],
                               causal=True, window=window)
    else:                                     # train / prefill
        # (B, S, H, D) -> (B, H, S, D) views; the kernel reads them through
        # their strides and returns its output in q's layout
        out = ops.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=True, window=window,
            softcap=cfg.attn_softcap).transpose(1, 2)
        new_cache = None
        if mode == "prefill" and cache is not None:
            new_cache = cache_from_prefill(cache, k, v)

    B, S = x.shape[:2]
    y = out.reshape(B, S, cfg.q_dim) @ p["wo"]
    return y, new_cache
