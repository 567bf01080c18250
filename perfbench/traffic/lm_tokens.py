"""Inputs of FL training over transformer clients, made from the seed on
the device: the model's initial weights (one generator a leaf, drawn in
the type they train in, one call a leaf) and each round's rows of
tokens.

Leaves are named by their path in the program's parameter tree
(``embed.embedding``, ``layers.0.moe.w_gate``, ...), each with the
layer-cycle dimension the tree stacks them over; every client starts
from the same weights.  Scales are the usual 1/sqrt(fan-in); the norm
weights are 1 + scale with scale ~ N(0, 0.05^2).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

from pb import seeds

NORM_STD = 0.05


def leaf_specs(m: Dict[str, Any]) -> List[Tuple[str, Tuple[int, ...], float]]:
    """(name, shape, init std) of every leaf, in a fixed order; a std of
    None marks a norm scale."""
    d, h, kv, hd, f = (m["d_model"], m["num_heads"], m["num_kv_heads"],
                       m["head_dim"], m["d_ff"])
    e, v = m["num_experts"], (m["vocab_size"] + 255) // 256 * 256
    if len(m["layer_pattern"]) != 1 or m["num_layers"] < 1:
        raise ValueError("one layer kind, at least one layer")
    n = (m["num_layers"],)
    specs = [("embed.embedding", (v, d), 1 / math.sqrt(d)),
             ("embed.unembed", (d, v), 1 / math.sqrt(d)),
             ("layers.0.norm1.scale", n + (d,), None),
             ("layers.0.attn.wq", n + (d, h * hd), 1 / math.sqrt(d)),
             ("layers.0.attn.wk", n + (d, kv * hd), 1 / math.sqrt(d)),
             ("layers.0.attn.wv", n + (d, kv * hd), 1 / math.sqrt(d)),
             ("layers.0.attn.wo", n + (h * hd, d), 1 / math.sqrt(h * hd)),
             ("layers.0.norm2.scale", n + (d,), None),
             ("layers.0.moe.router", n + (d, e), 1 / math.sqrt(d)),
             ("layers.0.moe.w_gate", n + (e, d, f), 1 / math.sqrt(d)),
             ("layers.0.moe.w_up", n + (e, d, f), 1 / math.sqrt(d)),
             ("layers.0.moe.w_down", n + (e, f, d), 1 / math.sqrt(f)),
             ("final_norm.scale", (d,), None)]
    return specs


def init_leaf(m: Dict[str, Any], name: str, seed: int, device,
              dtype=torch.bfloat16, out=None) -> torch.Tensor:
    """One leaf of the initial weights, the same on every call: into
    ``out`` when given (a row of the program's client stack)."""
    spec = {n: (s, std) for n, s, std in leaf_specs(m)}
    shape, std = spec[name]
    g = seeds.generator(device, seed, "lm/init", name)
    x = out if out is not None else torch.empty(shape, dtype=dtype,
                                                device=device)
    x.normal_(0.0, NORM_STD if std is None else std, generator=g)
    return x


def init_weights(m: Dict[str, Any], seed: int, device,
                 dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    return {name: init_leaf(m, name, seed, device, dtype)
            for name, _, _ in leaf_specs(m)}


def rows(fl: Dict[str, Any], m: Dict[str, Any], seed: int, rnd: int,
         device) -> Dict[str, torch.Tensor]:
    """Round ``rnd``'s batch: "tokens" and "labels" (C, rows, seq), the
    labels a stream's next ids, every row a fresh uniform draw."""
    c = fl["num_clients"]
    pcb = fl["global_batch"] // c
    g = seeds.generator(device, seed, "lm/tokens", rnd)
    stream = torch.randint(0, m["vocab_size"], (c, pcb, fl["seq_len"] + 1),
                           generator=g, device=device)
    return {"tokens": stream[..., :-1], "labels": stream[..., 1:]}
