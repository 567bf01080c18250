"""Model FLOPs of a decoder-only transformer with mixture-of-experts
layers (Mixtral's block), from the configuration's sizes.

Counted: every matrix product a token needs in the forward pass (the
q/k/v/o projections, the router, the routed experts' three products,
the unembedding) and the attention scores and their weighted sum over
the keys each query sees (causal, within the window), two FLOPs a
multiply-add; a training token counts three forwards' worth.  Not
counted: recomputation under remat, the experts a token is not routed
to, the embedding lookup, norms and every other elementwise step.
"""
from __future__ import annotations

from typing import Any, Dict


def active_matmul_params(m: Dict[str, Any]) -> int:
    """Weights a token multiplies by in one forward pass."""
    d, h, kv, hd = m["d_model"], m["num_heads"], m["num_kv_heads"], \
        m["head_dim"]
    attn = d * h * hd * 2 + d * kv * hd * 2
    experts = m["experts_per_token"] * 3 * d * m["d_ff"]
    router = d * m["num_experts"]
    return m["num_layers"] * (attn + experts + router) \
        + d * m["vocab_size"]


def total_params(m: Dict[str, Any]) -> int:
    """Every weight of the model (what stage 1 aggregates a client)."""
    d, h, kv, hd = m["d_model"], m["num_heads"], m["num_kv_heads"], \
        m["head_dim"]
    layer = (d * h * hd * 2 + d * kv * hd * 2 + d * m["num_experts"]
             + m["num_experts"] * 3 * d * m["d_ff"] + 2 * d)
    vocab = (m["vocab_size"] + 255) // 256 * 256
    return m["num_layers"] * layer + 2 * vocab * d + d


def attended_pairs(seq: int, window: int) -> int:
    """(query, key) pairs of one causal sequence within the window."""
    w = window if window else seq
    return sum(min(i + 1, w) for i in range(seq))


def forward_flops(m: Dict[str, Any], seq: int) -> int:
    """FLOPs of one sequence's forward pass."""
    pairs = attended_pairs(seq, m.get("window_size", 0))
    attn = m["num_layers"] * m["num_heads"] * pairs * m["head_dim"] * 4
    return 2 * active_matmul_params(m) * seq + attn


def train_flops(m: Dict[str, Any], seq: int, rows: int) -> int:
    """FLOPs of ``rows`` sequences through forward and backward."""
    return 3 * rows * forward_flops(m, seq)
