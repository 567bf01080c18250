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

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import kmeans as _kmeans
from repro_torch.kernels import ref
from repro_torch.kernels import weighted_agg as _wagg
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

LAUNCHES: Dict[str, int] = {"weighted_agg_multi": 0, "kmeans_assign": 0,
                            "weighted_agg": 0, "flash_attention": 0}
# flash_attention's launches by route (kernels/flash_attention.py): bf16 on
# the tensor cores, f32 on the CUDA cores; they sum to the total above
FLASH_ROUTES: Dict[str, int] = {_flash.TENSOR_CORES: 0, _flash.CUDA_CORES: 0}


def reset_launches() -> None:
    for counts in (LAUNCHES, FLASH_ROUTES):
        for name in counts:
            counts[name] = 0


def weighted_agg_multi(stack: torch.Tensor,
                       weights: torch.Tensor) -> torch.Tensor:
    """stack (C, P), weights (C, K) -> (K, P): all K weighted reductions
    in one pass over the stack (the one-leaf case of the grouped kernel)."""
    if stack.device.type == "cpu":
        return ref.weighted_agg_multi_ref(stack, weights)
    out = _wagg.launch(stack, weights)
    LAUNCHES["weighted_agg_multi"] += 1
    return out


def weighted_agg_multi_tree(tree: Any, weights: torch.Tensor) -> Any:
    """(C, ...) tree + (C, K) weights -> (K, ...) tree, leaf by leaf as
    the reference's tree form; on the card the leaves of each dtype go into
    one grouped launch for every 64 (one for LeNet's 10 leaves: one a
    stage-1; a bf16 model with f32 leaves, as the recurrent families'
    ``A_log``/``D``/``dt_bias``, one for each dtype), any K."""
    leaves = tree_leaves(tree)
    k = weights.shape[1]
    if not leaves or leaves[0].device.type == "cpu":
        outs = [ref.weighted_agg_multi_ref(x.reshape(x.shape[0], -1),
                                           weights).reshape((k,) + x.shape[1:])
                for x in leaves]
        return tree_unflatten(tree, outs)
    outs = [None] * len(leaves)
    for group in dtype_groups(leaves):     # (C, ...) leaves go in as they are
        got = _wagg.launch_grouped([leaves[i].contiguous() for i in group],
                                   weights)
        LAUNCHES["weighted_agg_multi"] += _wagg.launches(len(group))
        for i, out in zip(group, got):
            outs[i] = out
    return tree_unflatten(tree, outs)


def dtype_groups(leaves) -> Tuple[Tuple[int, ...], ...]:
    """The leaves' indices grouped by dtype, groups in the order of each
    dtype's first leaf: one grouped launch takes one dtype."""
    groups: Dict[torch.dtype, list] = {}
    for i, x in enumerate(leaves):
        groups.setdefault(x.dtype, []).append(i)
    return tuple(tuple(g) for g in groups.values())


def weighted_agg(stack: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """stack (C, P), weights (C,) -> (P,): the K = 1 case of the
    ``weighted_agg_multi`` kernel (``csrc/weighted_agg.cu``)."""
    if stack.device.type == "cpu":
        return ref.weighted_agg_ref(stack, weights)
    out = _wagg.launch(stack, weights.reshape(-1, 1))
    LAUNCHES["weighted_agg"] += 1
    return out.reshape(stack.shape[1])


def weighted_agg_tree(tree: Any, weights: torch.Tensor) -> Any:
    """Leaf-wise: (C, ...) tree + (C,) weights -> (...) tree, one launch
    per leaf, as the reference's tree form."""
    def one(x):
        return weighted_agg(x.reshape(x.shape[0], -1),
                            weights).reshape(x.shape[1:])
    return tree_map(one, tree)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D) -> (B, Hq, Sq, D): GQA,
    scale 1/sqrt(D), optional tanh soft-cap, causal and sliding-window masks
    with q tokens at the end of the kv axis (``q_pos = Sk - Sq + i``).
    On the card bf16 runs the tensor-core kernel and f32 the CUDA-core one
    (``FLASH_ROUTES`` counts each).  Forward only: the kernel's output
    carries no gradient, so on the card a call that autograd would
    differentiate raises (training attention takes
    ``models/attention.py``'s chunked route instead)."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       softcap=softcap)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention: the CUDA kernel is forward only; training "
            "takes models/attention.py's chunked route (mode='train'), and "
            "a backward kernel is ROADMAP queue 2, item e")
    out, route = _flash.launch(q, k, v, causal=causal, window=window,
                               softcap=softcap)
    LAUNCHES["flash_attention"] += 1
    FLASH_ROUTES[route] += 1
    return out


def kmeans_assign(x: torch.Tensor, centroids: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (N, D), centroids (K, D) -> (assignment (N,) int32, min squared
    distance (N,) f32)."""
    if x.device.type == "cpu":
        return ref.kmeans_assign_ref(x, centroids)
    out = _kmeans.launch(x, centroids)
    LAUNCHES["kmeans_assign"] += 1
    return out
