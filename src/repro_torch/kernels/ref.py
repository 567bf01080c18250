"""Plain PyTorch versions of the ported kernels: the correctness contract.

Counterpart of ``repro/kernels/ref.py``, function for function.  The
dispatching wrappers in `kernels/ops.py` take these for CPU tensors;
``chip_smoke.py`` holds the CUDA kernels against them on the card.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

NEG_INF = -1e30


def weighted_agg_ref(stack: torch.Tensor, weights: torch.Tensor
                     ) -> torch.Tensor:
    """stack (C, P), weights (C,) -> (P,) = sum_c w_c * stack_c,
    accumulated in float32 and returned in the stack's dtype."""
    return (weights.float() @ stack.float()).to(stack.dtype)


def weighted_agg_multi_ref(stack: torch.Tensor,
                           weights: torch.Tensor) -> torch.Tensor:
    """stack (C, P), weights (C, K) -> (K, P) = sum_c w_ck * stack_c,
    accumulated in float32 and returned in the stack's dtype."""
    return (weights.float().T @ stack.float()).to(stack.dtype)


def kmeans_assign_ref(x: torch.Tensor, centroids: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (N, D), centroids (K, D) -> (assignment (N,) int32, min squared
    distance (N,) f32), by the expanded ``|x|^2 - 2 x.c + |c|^2`` formula.
    ``argmin`` takes the first index on ties, as ``jnp.argmin`` does."""
    xf, cf = x.float(), centroids.float()
    d = ((xf * xf).sum(-1)[:, None] - 2.0 * xf @ cf.T
         + (cf * cf).sum(-1)[None, :])
    return torch.argmin(d, dim=1).to(torch.int32), d.min(dim=1).values


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0) -> torch.Tensor:
    """q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D) -> (B, Hq, Sq, D) in q's dtype.

    GQA by repeating each kv head for its Hq/Hkv query heads; scores in
    float32 times 1/sqrt(D), then the optional ``softcap * tanh(s /
    softcap)``; q tokens sit at the end of the kv axis (``q_pos = Sk - Sq +
    i``) for the causal and window masks, and masked scores take the finite
    ``NEG_INF``.  It materializes the (B, Hq, Sq, Sk) scores."""
    d = q.shape[-1]
    sq, sk = q.shape[2], k.shape[2]
    g = q.shape[1] // k.shape[1]
    kk = k.float().repeat_interleave(g, dim=1)
    vv = v.float().repeat_interleave(g, dim=1)
    s = (q.float() @ kk.transpose(-1, -2)) * (1.0 / math.sqrt(d))
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    q_pos = sk - sq + torch.arange(sq, device=q.device)
    k_pos = torch.arange(sk, device=q.device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    s = s.masked_fill(~mask, NEG_INF)
    return (torch.softmax(s, dim=-1) @ vv).to(q.dtype)
