"""GQA attention with chunked (online-softmax) computation, sliding
windows, logit soft-capping, QKV bias, ring-buffer KV caches and
cross-attention.  Counterpart of ``repro/models/attention.py``.

Three routes, as in the reference:

* **train** goes through :func:`chunk_attention` (global layers) and
  :func:`windowed_full_attention` (sliding-window layers), the reference's
  portable attention ported op for op to torch ops that autograd
  differentiates: scores and the weighted sum of values in float32 (the
  reference's ``preferred_element_type``); its map over query chunks is a
  batch dimension and its scan over key chunks a loop.  The reference
  never trains through its Pallas kernel (it has no backward), and neither
  does the port: ``kernels.ops.flash_attention`` refuses autograd on the
  card.
* **prefill** goes through ``kernels.ops.flash_attention``: the
  hand-written CUDA kernel on the card, its plain PyTorch version
  (``kernels/ref.py::flash_attention_ref``) on the CPU.  The positions are
  ``arange(S)`` and Sq == Sk, which is the kernel's contract
  (``q_pos = Sk - Sq + i``).
* **decode** attends over the ring-buffer cache with a ``slot_pos`` mask,
  outside that contract, so :func:`direct_attention` computes it in plain
  PyTorch (float32), as the reference computes it in one einsum, over
  blocks of cache slots so that no float32 copy of a whole cache exists.

Cross-attention (``kv_x``: whisper's decoder over the encoder's output)
and the encoder's non-causal self-attention (``causal=False``) take the
same split by mode: train through :func:`chunk_attention` with
``causal=False``, prefill (and the serving encode, which runs in
"prefill" mode) through ``ops.flash_attention`` with ``causal=False``.
Cross-attention in decode is one query row against all Sk keys with no
mask, which is the kernel's contract too (Sq = 1), so it also takes the
kernel.  As in the reference, cross-attention ropes neither q nor k,
keeps no cache, and re-projects its K/V from ``kv_x`` at every call (a
decode step included); the encoder's self-attention ropes both.

Cache layout per attention layer::

    {"k": (B, L, Hkv, D), "v": (B, L, Hkv, D), "slot_pos": (L,) int32}

or, int8-quantized (``init_cache(quantized=True)``, the profiles with
``kv_int8``: grok-1-314b, qwen2-72b)::

    {"k", "v": (B, L, Hkv, D) int8, "k_scale", "v_scale": (B, L, Hkv) f32,
     "slot_pos": (L,) int32}

``slot_pos[s]`` is the absolute position held in slot ``s`` (-1 = empty).
Sliding-window layers use L = window_size as a ring buffer (slot = pos % L);
full-attention layers use L = max sequence length.  Prefill attends over
the unquantized K/V and quantizes only what it writes; decode folds the
scales into the scores and the probabilities.  Unlike the reference,
whose arrays are immutable, the port writes prefill and decode results into
the cache tensors in place (the caller's dict is updated and returned), so a
decode step does not copy a 26-layer cache.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.shapes import effective_cache_len
from repro_torch.kernels import ops
from repro_torch.models.layers import _init, apply_rope, rope_frequencies, softcap
from repro_torch.sharding import parallel as P

NEG_INF = -1e30


def init_attention(cfg, gen, dtype, device, lead=(),
                   cross: bool = False) -> dict:
    """wq, wk, wv, wo (and the QKV biases of a ``qkv_bias`` config, but
    not for a cross-attention layer), with a leading ``lead`` shape."""
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    lead = tuple(lead)
    s = 1.0 / math.sqrt(d)
    p = {
        "wq": _init(gen, lead + (d, qd), s, dtype, device),
        "wk": _init(gen, lead + (d, kvd), s, dtype, device),
        "wv": _init(gen, lead + (d, kvd), s, dtype, device),
        "wo": _init(gen, lead + (qd, d), 1.0 / math.sqrt(qd), dtype, device),
    }
    if cfg.qkv_bias and not cross:
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


# --------------------------------------------------------------------------
# Chunked (online-softmax) attention core: the train route
# --------------------------------------------------------------------------

def chunk_attention(cfg, q, k, v, q_pos, k_pos, *, causal: bool,
                    window: int = 0, q_chunk: int = 512,
                    kv_chunk: int = 1024) -> torch.Tensor:
    """Memory-bounded attention.

    q: (B, Sq, Hq, D); k/v: (B, Sk, Hkv, D); q_pos: (Sq,); k_pos: (Sk,).
    Entries with k_pos < 0 are masked (empty cache slots).
    Returns (B, Sq, Hq, D) in q's dtype.

    The reference scans over query chunks with no carry (a map) and, inside,
    over key chunks carrying the online softmax.  Here the query chunks are
    a batch dimension and the key chunks a loop: each (query chunk, key
    chunk) pair does the reference's arithmetic, in a launch a key chunk
    instead of one a pair.
    """
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)

    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Sk)
    # pad to chunk multiples
    pq = (-Sq) % q_chunk
    pk = (-Sk) % kv_chunk
    if pq:
        q = F.pad(q, (0, 0, 0, 0, 0, pq))
        q_pos = F.pad(q_pos, (0, pq), value=2**30)
    if pk:
        k = F.pad(k, (0, 0, 0, 0, 0, pk))
        v = F.pad(v, (0, 0, 0, 0, 0, pk))
        k_pos = F.pad(k_pos, (0, pk), value=-1)
    nq, nk = q.shape[1] // q_chunk, k.shape[1] // kv_chunk

    # queries (B, Hkv, nq * G * qc, D), the rows ordered (chunk, group,
    # position); keys and values (nk, B, Hkv, kc, D); scores and softmax
    # state viewed as (B, Hkv, nq, G, qc, ...)
    qf = (q.reshape(B, nq, q_chunk, Hkv, G, D).permute(0, 3, 1, 4, 2, 5)
          .float().reshape(B, Hkv, nq * G * q_chunk, D))
    qp = q_pos.reshape(nq, 1, q_chunk, 1)
    kc = k.reshape(B, nk, kv_chunk, Hkv, D).permute(1, 0, 3, 2, 4).float()
    vc = v.reshape(B, nk, kv_chunk, Hkv, D).permute(1, 0, 3, 2, 4)
    kp = k_pos.reshape(nk, kv_chunk)
    state = (B, Hkv, nq, G, q_chunk)

    m = torch.full(state, NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(state, dtype=torch.float32, device=q.device)
    o = torch.zeros(state + (D,), dtype=torch.float32, device=q.device)
    for j in range(nk):
        kp_j = kp[j]
        s = (qf @ kc[j].transpose(-1, -2)).view(state + (kv_chunk,)) * scale
        if cfg.attn_softcap:
            s = softcap(s, cfg.attn_softcap)
        mask = kp_j >= 0                              # (nq, G=1, qc, kc)
        if causal:
            mask = mask & (kp_j <= qp)
        if window:
            mask = mask & (kp_j > qp - window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p_ij = torch.exp(s - m_new[..., None])
        l = l * alpha + p_ij.sum(-1)
        pv = (p_ij.to(v.dtype).float().reshape(B, Hkv, -1, kv_chunk)
              @ vc[j].float())
        o = o * alpha[..., None] + pv.view(state + (D,))
        m = m_new
    out = o / l.clamp_min(1e-30)[..., None]           # (B, Hkv, nq, G, qc, D)
    out = out.permute(0, 2, 4, 1, 3, 5).reshape(B, nq * q_chunk, Hq, D)
    return out[:, :Sq].to(q.dtype)


def windowed_full_attention(cfg, q, k, v, q_pos, k_pos, window: int,
                            q_chunk: int = 512) -> torch.Tensor:
    """Linear-cost sliding-window attention for full sequences: per query
    chunk, only a static slice of K/V of length (window + q_chunk) is
    attended.  Falls back to :func:`chunk_attention` when the sequence is
    short."""
    B, Sq, Hq, D = q.shape
    Sk = k.shape[1]
    span = window + q_chunk
    if Sk <= span or Sk != Sq:
        return chunk_attention(cfg, q, k, v, q_pos, k_pos, causal=True,
                               window=window, q_chunk=q_chunk)
    pq = (-Sq) % q_chunk
    if pq:
        q = F.pad(q, (0, 0, 0, 0, 0, pq))
        q_pos = F.pad(q_pos, (0, pq), value=2**30)
    nq = q.shape[1] // q_chunk
    qc = q.reshape(B, nq, q_chunk, Hq, D)
    qp = q_pos.reshape(nq, q_chunk)
    outs = []
    for i in range(nq):
        st = min(max(i * q_chunk + q_chunk - span, 0), Sk - span)
        outs.append(chunk_attention(
            cfg, qc[:, i], k[:, st:st + span], v[:, st:st + span], qp[i],
            k_pos[st:st + span], causal=True, window=window,
            q_chunk=q_chunk, kv_chunk=min(1024, span)))
    out = torch.stack(outs, 1).reshape(B, nq * q_chunk, Hq, D)
    return out[:, :Sq]


DECODE_BLOCK_BYTES = 256 << 20   # float32 bytes of K (or V) a block of slots


def _slot_block(B: int, L: int, Hkv: int, D: int) -> int:
    """Cache slots a block of :func:`direct_attention` takes: its float32
    K (or V) stays under DECODE_BLOCK_BYTES."""
    return max(1, min(L, DECODE_BLOCK_BYTES // (4 * B * Hkv * D)))


def _f32_heads(x: torch.Tensor, a: int, b: int) -> torch.Tensor:
    """Slots [a, b) of a (B, L, H, D) cache as a float32 (B, H, b - a, D)
    tensor, cast and laid out for a batched product in one pass."""
    B, _, H, D = x.shape
    out = torch.empty((B, H, b - a, D), dtype=torch.float32, device=x.device)
    return out.copy_(x[:, a:b].permute(0, 2, 1, 3))


def direct_attention(cfg, q, k, v, q_pos, k_pos, *, causal: bool,
                     window: int = 0, k_scale=None, v_scale=None,
                     block: Optional[int] = None):
    """Unchunked attention for tiny Sq (decode), in float32: the scores
    over the whole cache, one softmax, the weighted sum of values.  q (B,
    Sq, Hq, D), k/v (B, L, Hkv, D), q_pos (Sq,), k_pos (L,); entries with
    k_pos < 0 are masked (empty slots).

    int8 caches: the per-slot scales (B, L, Hkv) fold into the dots,
    score = (q . k_int8) * k_scale[slot] and out = sum (p * v_scale) v_int8,
    in the reference's order.  K and V are cast to float32 ``block`` slots
    at a time (default :func:`_slot_block`), so a 32k-slot cache never has
    a float32 copy; the scores (B, Hkv, G, Sq, L) are whole."""
    B, Sq, Hq, D = q.shape
    L, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    block = block or _slot_block(B, L, Hkv, D)
    # (B, Hkv, G * Sq, D): a kv head's queries, its group then positions
    qh = (q.float().reshape(B, Sq, Hkv, G, D).permute(0, 2, 3, 1, 4)
          .reshape(B, Hkv, G * Sq, D))
    s = torch.cat([qh @ _f32_heads(k, a, min(a + block, L)).transpose(-1, -2)
                   for a in range(0, L, block)], -1)
    s = s.view(B, Hkv, G, Sq, L) * (1.0 / math.sqrt(D))
    if k_scale is not None:
        s = s * k_scale.permute(0, 2, 1)[:, :, None, None, :]
    if cfg.attn_softcap:
        s = softcap(s, cfg.attn_softcap)
    mask = k_pos[None, :] >= 0
    if causal:
        mask = mask & (k_pos[None, :] <= q_pos[:, None])
    if window:
        mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
    p = torch.softmax(s.masked_fill(~mask, NEG_INF), dim=-1)
    if v_scale is not None:
        p = p * v_scale.permute(0, 2, 1)[:, :, None, None, :]
    p = p.reshape(B, Hkv, G * Sq, L)
    out = None
    for a in range(0, L, block):
        o = p[..., a:a + block] @ _f32_heads(v, a, min(a + block, L))
        out = o if out is None else out + o
    out = out.reshape(B, Hkv, G, Sq, D).permute(0, 3, 1, 2, 4)
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


# --------------------------------------------------------------------------
# Cache helpers
# --------------------------------------------------------------------------

def init_cache(cfg, kind: str, batch: int, max_len: int, dtype, device,
               quantized: bool = False, lead=(), shards: int = 1) -> dict:
    """KV cache of one layer, with a leading ``lead`` shape (the cycles of
    a stacked pattern position).  ``quantized`` stores int8 K/V with
    per-(B, slot, head) f32 scales: half the bytes of a bf16 cache.
    ``shards`` (the "model" size of a mesh) keeps one block of the L
    slots where it divides them; ``slot_pos`` always has all L."""
    L = effective_cache_len(cfg, kind, max_len)
    Ll = L // shards if L % shards == 0 else L
    H, D = cfg.num_kv_heads, cfg.head_dim
    lead = tuple(lead)
    kv_dtype = torch.int8 if quantized else dtype
    c = {"k": torch.zeros(lead + (batch, Ll, H, D), dtype=kv_dtype,
                          device=device),
         "v": torch.zeros(lead + (batch, Ll, H, D), dtype=kv_dtype,
                          device=device),
         "slot_pos": torch.full(lead + (L,), -1, dtype=torch.int32,
                                device=device)}
    if quantized:
        for name in ("k_scale", "v_scale"):
            c[name] = torch.zeros(lead + (batch, Ll, H),
                                  dtype=torch.float32, device=device)
    return c


def _quantize_kv(x):
    """x (..., D) -> (int8 values, f32 scale over D): the scale is
    ``max(amax, 1e-6) / 127``, the values rounded half to even and clipped
    to +-127."""
    xf = x.float()
    scale = xf.abs().amax(-1).clamp_min(1e-6) / 127.0
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def _cache_write_decode(cache, k_new, v_new, pos: torch.Tensor):
    """Write one token (B, 1, Hkv, D) at ring slot pos % L, in place
    (quantized first for an int8 cache).  ``pos`` is a (1,) tensor on the
    cache's device: no host sync."""
    slot = torch.remainder(pos, cache["k"].shape[1]).long()
    if "k_scale" in cache:
        k_new, ks = _quantize_kv(k_new)
        v_new, vs = _quantize_kv(v_new)
        cache["k_scale"].index_copy_(1, slot, ks)
        cache["v_scale"].index_copy_(1, slot, vs)
    cache["k"].index_copy_(1, slot, k_new)
    cache["v"].index_copy_(1, slot, v_new)
    cache["slot_pos"].index_copy_(0, slot, pos.to(torch.int32))
    return cache


def cache_from_prefill(cache, k, v):
    """Fill a cache from full-sequence K/V (B, S, Hkv, D), ring-consistent,
    in place (quantized first for an int8 cache)."""
    L = cache["k"].shape[1]
    S = k.shape[1]
    new = {"k": k, "v": v}
    if "k_scale" in cache:
        new["k"], new["k_scale"] = _quantize_kv(k)
        new["v"], new["v_scale"] = _quantize_kv(v)
    if L >= S:
        for name, x in new.items():
            cache[name][:, :S] = x
        cache["slot_pos"][:S] = torch.arange(S, dtype=torch.int32,
                                             device=k.device)
        return cache
    # ring layout: position p lives at slot p % L, so the last L positions
    # [S - L, S) land at a roll of the tail
    shift = (S - L) % L
    for name, x in new.items():
        cache[name].copy_(torch.roll(x[:, S - L:], shift, dims=1))
    cache["slot_pos"].copy_(torch.roll(
        torch.arange(S - L, S, dtype=torch.int32, device=k.device), shift))
    return cache


# --------------------------------------------------------------------------
# Full layer application
# --------------------------------------------------------------------------

def apply_attention(cfg, p, x, *, kind: str, mode: str,
                    positions: torch.Tensor, cache: Optional[dict] = None,
                    kv_x: Optional[torch.Tensor] = None,
                    causal: bool = True, tp=None
                    ) -> Tuple[torch.Tensor, Optional[dict]]:
    """One attention layer.  mode: "train" | "prefill" | "decode";
    ``positions`` is (S,) absolute positions of x's tokens (in decode, one
    position).  ``kv_x`` (B, Sk, d_model), the cross-attention source,
    disables the cache, rope and the causal mask; ``causal=False`` (the
    encoder) attends over the whole sequence and keeps no cache.  Returns
    (y, cache), the cache updated in place (None for cross-attention).
    ``tp`` (`sharding/parallel.TP`) runs the mesh program,
    :func:`_apply_attention_tp`."""
    window = cfg.window_size if kind in ("swa", "local") else 0
    if tp is not None and tp.active:
        return _apply_attention_tp(cfg, p, x, window=window, mode=mode,
                                   positions=positions, cache=cache,
                                   causal=causal, tp=tp, kv_x=kv_x)
    q = _project_q(cfg, p, x)
    new_cache = None
    if kv_x is not None:                      # cross-attention (enc-dec)
        k, v = _project_kv(cfg, p, kv_x)
        if mode == "train":
            k_pos = torch.arange(k.shape[1], dtype=torch.int32,
                                 device=k.device)
            out = chunk_attention(cfg, q, k, v, positions, k_pos,
                                  causal=False)
        else:                                 # prefill, and decode (Sq = 1)
            out = _flash(cfg, q, k, v, causal=False)
    else:
        sin, cos = rope_frequencies(cfg, positions)
        q = apply_rope(q, sin, cos)
        k, v = _project_kv(cfg, p, x)
        k = apply_rope(k, sin, cos)
        if mode == "decode":
            new_cache = _cache_write_decode(cache, k, v, positions)
            out = direct_attention(cfg, q, new_cache["k"], new_cache["v"],
                                   positions, new_cache["slot_pos"],
                                   causal=causal, window=window,
                                   k_scale=new_cache.get("k_scale"),
                                   v_scale=new_cache.get("v_scale"))
        elif mode == "train":
            if not causal:
                out = chunk_attention(cfg, q, k, v, positions, positions,
                                      causal=False)
            elif window:
                out = windowed_full_attention(cfg, q, k, v, positions,
                                              positions, window)
            else:
                out = chunk_attention(cfg, q, k, v, positions, positions,
                                      causal=True)
        else:                                 # prefill
            out = _flash(cfg, q, k, v, causal=causal,
                         window=window if causal else 0)
            if cache is not None:
                new_cache = cache_from_prefill(cache, k, v)

    B, S = x.shape[:2]
    y = out.reshape(B, S, cfg.q_dim) @ p["wo"]
    return y, new_cache


def _flash(cfg, q, k, v, *, causal: bool, window: int = 0):
    """``ops.flash_attention`` on (B, S, H, D) activations: (B, H, S, D)
    views go in, which the kernel reads through their strides, and its
    output comes back in q's layout."""
    return ops.flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=window,
        softcap=cfg.attn_softcap).transpose(1, 2)


# --------------------------------------------------------------------------
# The mesh program: tensor parallelism over "model", FSDP over "data"
# --------------------------------------------------------------------------

def _kv_for_heads(k, h0: int, h1: int, group: int):
    """The kv heads that query heads ``[h0, h1)`` read, laid out so that
    local query head ``i`` reads local kv head ``i // (h1 - h0) *
    n_kv``: whole groups, one kv head for all of them, or (a range across
    part of a group) one kv head a query head."""
    a, b = h0 // group, (h1 - 1) // group + 1
    if (h0 % group == 0 and (h1 - h0) % group == 0) or b - a == 1:
        return k[:, :, a:b]
    idx = torch.arange(h0, h1, device=k.device) // group
    return k.index_select(2, idx)


def _slot_positions(L: int, S: int, device) -> torch.Tensor:
    """The position each slot of an L-slot cache holds after a prefill of
    S positions (-1: empty), as :func:`cache_from_prefill` lays them."""
    s = torch.arange(L, dtype=torch.int32, device=device)
    if L >= S:
        return torch.where(s < S, s, -1)
    return (S - L) + torch.remainder(s - (S - L), L)


def _new_entries(cache, k, v) -> dict:
    new = {"k": k, "v": v}
    if "k_scale" in cache:
        new["k"], new["k_scale"] = _quantize_kv(k)
        new["v"], new["v_scale"] = _quantize_kv(v)
    return new


def cache_from_prefill_block(cache, k, v, lo: int):
    """:func:`cache_from_prefill` into a cache that holds slots ``[lo, lo +
    L_local)`` of its L (``slot_pos`` whole, as the reference's
    placement keeps it), from the full-sequence K/V, in place."""
    Ll, L, S = cache["k"].shape[1], cache["slot_pos"].shape[0], k.shape[1]
    pos = _slot_positions(L, S, k.device)
    cache["slot_pos"].copy_(pos)
    for name, x in _new_entries(cache, k, v).items():
        if L >= S:
            n = max(0, min(S - lo, Ll))
            cache[name][:, :n] = x[:, lo:lo + n]
        else:
            cache[name].copy_(x.index_select(1, pos[lo:lo + Ll].long()))
    return cache


def _cache_write_decode_block(cache, k_new, v_new, pos: torch.Tensor,
                              lo: int):
    """:func:`_cache_write_decode` into a block of slots ``[lo, lo +
    L_local)``: the token lands only on the rank that owns slot ``pos %
    L`` (by slot, so a ring cache works); ``slot_pos`` is written on every
    rank.  No host sync."""
    Ll, L = cache["k"].shape[1], cache["slot_pos"].shape[0]
    slot = torch.remainder(pos, L).long()
    local = slot - lo
    inside = (local >= 0) & (local < Ll)
    idx = local.clamp(0, Ll - 1)
    for name, x in _new_entries(cache, k_new, v_new).items():
        keep = cache[name].index_select(1, idx)
        cache[name].index_copy_(
            1, idx, torch.where(inside.reshape((1,) * x.dim()), x, keep))
    cache["slot_pos"].index_copy_(0, slot, pos.to(torch.int32))
    return cache


def _partial_attention(cfg, q, k, v, q_pos, k_pos, *, causal: bool,
                       window: int = 0, k_scale=None, v_scale=None):
    """:func:`direct_attention`'s sums over some of the slots, for a merge
    across ranks: each query row's largest masked score ``m``, ``l = sum
    exp(s - m)`` and ``o = sum exp(s - m) v`` (float32, unnormalized),
    (B, Hkv, G * Sq) and (B, Hkv, G * Sq, D)."""
    B, Sq, Hq, D = q.shape
    L, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    block = _slot_block(B, L, Hkv, D)
    qh = (q.float().reshape(B, Sq, Hkv, G, D).permute(0, 2, 3, 1, 4)
          .reshape(B, Hkv, G * Sq, D))
    s = torch.cat([qh @ _f32_heads(k, a, min(a + block, L)).transpose(-1, -2)
                   for a in range(0, L, block)], -1)
    s = s.view(B, Hkv, G, Sq, L) * (1.0 / math.sqrt(D))
    if k_scale is not None:
        s = s * k_scale.permute(0, 2, 1)[:, :, None, None, :]
    if cfg.attn_softcap:
        s = softcap(s, cfg.attn_softcap)
    mask = k_pos[None, :] >= 0
    if causal:
        mask = mask & (k_pos[None, :] <= q_pos[:, None])
    if window:
        mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
    s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(-1)
    e = torch.exp(s - m[..., None])
    l = e.sum(-1)
    if v_scale is not None:
        e = e * v_scale.permute(0, 2, 1)[:, :, None, None, :]
    e = e.reshape(B, Hkv, G * Sq, L)
    o = None
    for a in range(0, L, block):
        part = e[..., a:a + block] @ _f32_heads(v, a, min(a + block, L))
        o = part if o is None else o + part
    return m.reshape(B, Hkv, G * Sq), l.reshape(B, Hkv, G * Sq), o


def _decode_split(cfg, q, cache, positions, *, causal, window, tp, lo):
    """Decode attention split over the sequence: every head over this
    rank's slots, merged by log-sum-exp across "model" (a max, then one
    all-reduce of the rescaled sums).  q (B, 1, Hq, D) whole."""
    Ll = cache["k"].shape[1]
    m, l, o = _partial_attention(
        cfg, q, cache["k"], cache["v"], positions,
        cache["slot_pos"][lo:lo + Ll], causal=causal, window=window,
        k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"))
    a = torch.exp(m - P.max_over_model(tp, m))
    lo_ = P.reduce_from_model(tp, torch.cat([(l * a)[..., None],
                                             o * a[..., None]], -1))
    out = lo_[..., 1:] / lo_[..., :1]
    B, Sq, Hq, D = q.shape
    Hkv = cache["k"].shape[2]
    out = out.reshape(B, Hkv, Hq // Hkv, Sq, D).permute(0, 3, 1, 2, 4)
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


def _rope(x, sin, cos):
    return x if sin is None else apply_rope(x, sin, cos)


def _apply_attention_tp(cfg, p, x, *, window: int, mode: str, positions,
                        cache, causal: bool, tp, kv_x=None):
    """One attention layer on a mesh.  ``wq``/``wk``/``wv`` are
    column-parallel and ``wo`` row-parallel over "model" where their
    widths divide (a rank's columns need not be whole heads); FSDP leaves
    are gathered over "data" at use.  K and V are all-gathered over
    "model" (small next to q).  Train and prefill compute, on each rank,
    the heads that cover its q columns (q all-gathered first where a rank
    holds part of a head), through the same routes as one device (the
    chunked train attention; flash in prefill), and keep the rank's
    columns for ``wo``, whose output is all-reduced.  The KV cache keeps
    the reference's placement: its slots split over "model" where they
    divide, ``slot_pos`` whole.  Prefill writes the rank's block of slots
    from the gathered K/V; decode writes the new token on the rank that
    owns its slot and attends over the sequence split
    (:func:`_decode_split`).

    Cross-attention (``kv_x``, whisper's decoder over the encoder's
    output) projects K and V from ``kv_x`` with the rank's ``wk``/``wv``
    columns (``kv_x`` through `parallel.copy_to_model`: every decoder
    layer's share of its gradient is summed over "model"), keeps no cache,
    ropes nothing, masks nothing, and in every mode, decode (Sq = 1)
    included, attends on the heads that cover the rank's q columns: flash
    in prefill and decode, the chunked route in training.  Where the
    rank's K/V columns are the kv heads of its whole groups of q heads,
    they stay on the rank (no gather, as the reference's placement
    computes them); else they are gathered as self-attention's are."""
    d, hd = cfg.d_model, cfg.head_dim
    Hq, Hkv = cfg.num_heads, cfg.num_kv_heads
    wq, wk, wv = (P.fsdp_gather(tp, p[n], -2, d) for n in ("wq", "wk", "wv"))
    wo = P.fsdp_gather(tp, p["wo"], -1, d)
    q_split = P.is_split(wq.shape[-1], cfg.q_dim)
    kv_split = P.is_split(wk.shape[-1], cfg.kv_dim)
    cross = kv_x is not None
    if cross:
        causal, window = False, 0
        xc = P.copy_to_model(tp, x) if q_split else x
        src = kv_x
        src_c = P.copy_to_model(tp, kv_x) if kv_split else kv_x
    else:
        xc = P.copy_to_model(tp, x) if q_split or kv_split else x
        src, src_c = x, xc
    B, S = x.shape[:2]
    Sk = src.shape[1]
    G = Hq // Hkv

    c0, c1 = P.block(tp, wq.shape[-1], cfg.q_dim)   # this rank's q columns
    whole = c0 % hd == 0 and c1 % hd == 0
    # cross-attention keeps its K/V columns where they are the kv heads of
    # the rank's whole groups of q heads (no cache wants the rest)
    k0, k1 = P.block(tp, wk.shape[-1], cfg.kv_dim)
    own_kv = (cross and kv_split and c0 % (hd * G) == 0
              and c1 % (hd * G) == 0 and (k0, k1) == (c0 // G, c1 // G))
    q = xc @ wq
    if "bq" in p:
        q = q + p["bq"]
    kv = []
    for w, b in ((wk, "bk"), (wv, "bv")):
        t = (src_c if kv_split else src) @ w
        if b in p:
            t = t + p[b]
        if kv_split and not own_kv:
            t = P.gather_model(tp, t, -1)
        elif q_split and not kv_split:
            t = P.copy_to_model(tp, t)       # whole, read split by heads
        kv.append(t.reshape(B, Sk, -1, hd))
    k, v = kv
    # cross-attention ropes neither q nor k
    sin, cos = (None, None) if cross else rope_frequencies(cfg, positions)
    k = _rope(k, sin, cos)

    if (mode == "decode" and not cross) or not whole:
        q = P.gather_model(tp, q, -1) if q_split else q
        h0, h1 = c0 // hd, -(-c1 // hd)
        q = _rope(q.reshape(B, S, Hq, hd), sin, cos)
    else:
        h0, h1 = c0 // hd, c1 // hd
        q = _rope(q.reshape(B, S, h1 - h0, hd), sin, cos)

    new_cache = None
    if mode == "decode" and not cross:
        Ll, L = cache["k"].shape[1], cache["slot_pos"].shape[0]
        lo = P.block(tp, Ll, L)[0]
        new_cache = _cache_write_decode_block(cache, k, v, positions, lo)
        if Ll != L:
            out = _decode_split(cfg, q, new_cache, positions, causal=causal,
                                window=window, tp=tp, lo=lo)
        else:
            out = direct_attention(cfg, q, new_cache["k"], new_cache["v"],
                                   positions, new_cache["slot_pos"],
                                   causal=causal, window=window,
                                   k_scale=new_cache.get("k_scale"),
                                   v_scale=new_cache.get("v_scale"))
        h0, h1 = 0, Hq
    else:
        if q.shape[2] == Hq:                # all heads: keep those of [c0, c1)
            q = q[:, :, h0:h1]
        ks, vs = ((k, v) if own_kv
                  else (_kv_for_heads(t, h0, h1, G) for t in (k, v)))
        k_pos = (torch.arange(Sk, dtype=torch.int32, device=x.device)
                 if cross else positions)
        if mode == "train":
            if window:
                out = windowed_full_attention(cfg, q, ks, vs, positions,
                                              positions, window)
            else:
                out = chunk_attention(cfg, q, ks, vs, positions, k_pos,
                                      causal=causal)
        else:                               # prefill; cross-attention decode
            out = _flash(cfg, q, ks, vs, causal=causal,
                         window=window if causal else 0)
            if cache is not None and not cross:
                Ll, L = cache["k"].shape[1], cache["slot_pos"].shape[0]
                new_cache = cache_from_prefill_block(
                    cache, k, v, P.block(tp, Ll, L)[0])
    out = out.reshape(B, S, (h1 - h0) * hd)[..., c0 - h0 * hd:c1 - h0 * hd]
    y = out @ wo
    return (P.reduce_from_model(tp, y) if q_split else y), new_cache
