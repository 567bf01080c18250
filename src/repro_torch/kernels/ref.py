"""Plain PyTorch versions of the ported kernels: the correctness contract.

Counterpart of ``repro/kernels/ref.py`` (``weighted_agg_multi_ref`` and
``kmeans_assign_ref``).  The dispatching wrappers in `kernels/ops.py` take
these for CPU tensors; ``chip_smoke.py`` holds the CUDA kernels against
them on the card.
"""
from __future__ import annotations

from typing import Tuple

import torch


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
