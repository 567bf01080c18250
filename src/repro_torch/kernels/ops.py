"""Dispatching wrappers for the ported kernels.

A CUDA tensor launches the hand-written kernel (or raises); a CPU tensor
takes the plain PyTorch version in `kernels/ref.py`.  There is no fallback
between the two.  Each wrapper adds one to ``LAUNCHES[name]`` where it
launches its kernel and nowhere else, so a run can show that its main path
went through the kernels: set the counts to 0 with :func:`reset_launches`,
run, read ``LAUNCHES``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.kernels import kmeans as _kmeans
from repro_torch.kernels import ref
from repro_torch.kernels import weighted_agg as _wagg
from repro_torch.tree import tree_map

LAUNCHES: Dict[str, int] = {"weighted_agg_multi": 0, "kmeans_assign": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def weighted_agg_multi(stack: torch.Tensor,
                       weights: torch.Tensor) -> torch.Tensor:
    """stack (C, P), weights (C, K) -> (K, P): all K weighted reductions
    in one pass over the stack."""
    if stack.device.type == "cpu":
        return ref.weighted_agg_multi_ref(stack, weights)
    out = _wagg.launch(stack, weights)
    LAUNCHES["weighted_agg_multi"] += 1
    return out


def weighted_agg_multi_tree(tree: Any, weights: torch.Tensor) -> Any:
    """Leaf-wise: (C, ...) tree + (C, K) weights -> (K, ...) tree, one
    launch per leaf (10 for LeNet), as the reference's tree form."""
    k = weights.shape[1]

    def one(x):
        flat = x.reshape(x.shape[0], -1)
        return weighted_agg_multi(flat, weights).reshape((k,) + x.shape[1:])
    return tree_map(one, tree)


def kmeans_assign(x: torch.Tensor, centroids: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (N, D), centroids (K, D) -> (assignment (N,) int32, min squared
    distance (N,) f32)."""
    if x.device.type == "cpu":
        return ref.kmeans_assign_ref(x, centroids)
    out = _kmeans.launch(x, centroids)
    LAUNCHES["kmeans_assign"] += 1
    return out
