"""FedHC aggregation: loss-weighted intra-cluster (Eq. 5 + Eq. 12) and
two-stage hierarchical (cluster -> ground station) model averaging.

Counterpart of ``repro/core/aggregation.py``: the one-hot segment-matmul
form over a leading clients dim, so a re-clustering is a data change.
``cluster_aggregate(use_kernels=True)`` sends the stage-1 reduction
through the hand-written ``weighted_agg_multi`` kernel (`kernels/ops.py`);
otherwise it is a plain matmul per leaf.

:func:`hierarchical_round` has stage 1 hoisted out of the stage-2 choice,
as ``repro/core/aggregation_spmd.py::hierarchical_round_sharded`` does;
``do_global`` is a Python bool (for always-up methods it depends only on
the round index).  The client-axis sharding of that module waits for the
multi-GPU slice.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kernel_ops
from repro_torch.tree import tree_map


def tree_weighted_sum(stack: Any, weights: torch.Tensor) -> Any:
    """stack: tree with leading clients dim C; weights (C,) -> tree."""
    def one(x):
        w = weights.float().reshape((-1,) + (1,) * (x.dim() - 1))
        return (x.float() * w).sum(0).to(x.dtype)
    return tree_map(one, stack)


def membership_one_hot(assignment: torch.Tensor, k: int) -> torch.Tensor:
    """The (C, K) f32 cluster-membership matrix."""
    return F.one_hot(assignment.long(), k).float()


def loss_weights(losses, assignment, k: int, participating=None,
                 one_hot: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Eq. 12: p_i = (1/L_i) / sum_{j in cluster(i)} (1/L_j), masked by
    participation, normalized within each cluster.  Returns (C,)."""
    inv = 1.0 / losses.float().clamp_min(1e-8)
    if participating is not None:
        inv = inv * participating.float()
    if one_hot is None:
        one_hot = membership_one_hot(assignment, k)
    denom = one_hot.T @ inv                                       # (K,)
    return inv / denom[assignment.long()].clamp_min(1e-12)


def data_weights(data_sizes, participating=None) -> torch.Tensor:
    """Eq. 5 FedAvg weights: D_i / D (flat, no clusters)."""
    d = data_sizes.float()
    if participating is not None:
        d = d * participating.float()
    return d / d.sum().clamp_min(1e-12)


def cluster_weights(losses, data_sizes, assignment, k: int,
                    participating=None, *, loss_weighted: bool = True,
                    one_hot: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stage-1 per-client weights: Eq. 12 inverse-loss weights or
    per-cluster FedAvg data-size weights, both cluster-normalized."""
    if loss_weighted:
        return loss_weights(losses, assignment, k, participating,
                            one_hot=one_hot)
    d = data_sizes.float()
    if participating is not None:
        d = d * participating.float()
    if one_hot is None:
        one_hot = membership_one_hot(assignment, k)
    denom = one_hot.T @ d
    return d / denom[assignment.long()].clamp_min(1e-12)


def cluster_aggregate(stack: Any, weights: torch.Tensor,
                      assignment: torch.Tensor, k: int, *,
                      use_kernels: bool = False,
                      one_hot: Optional[torch.Tensor] = None) -> Any:
    """Stage 1: per-cluster weighted average of a (C, ...) tree with
    cluster-normalized weights (C,) -> (K, ...) tree of cluster models.
    The one-hot mask is folded into one (C, K) weight matrix, so all K
    cluster models come from one pass over the stack."""
    if one_hot is None:
        one_hot = membership_one_hot(assignment, k)
    wm = one_hot * weights.float()[:, None]                       # (C,K)
    if use_kernels:
        return kernel_ops.weighted_agg_multi_tree(stack, wm)

    def one(x):
        flat = x.reshape(x.shape[0], -1).float()
        return (wm.T @ flat).reshape((k,) + x.shape[1:]).to(x.dtype)
    return tree_map(one, stack)


def global_aggregate(cluster_stack: Any, cluster_data_sizes) -> Any:
    """Stage 2 (ground station, Alg. 1 line 23): w_G = sum_k (D_k/D) w^k."""
    return tree_weighted_sum(cluster_stack, data_weights(cluster_data_sizes))


def broadcast_clusters(cluster_stack: Any, assignment: torch.Tensor) -> Any:
    """Distribute cluster models back to members: (K,...) -> (C,...)."""
    idx = assignment.long()
    return tree_map(lambda x: x[idx], cluster_stack)


def broadcast_global(tree: Any, num_clients: int) -> Any:
    """(...) -> (C, ...), materialized (later steps write per client)."""
    return tree_map(lambda x: x[None].expand((num_clients,) + x.shape)
                    .contiguous(), tree)


def global_round(cluster_models, data_sizes, assignment, k: int,
                 num_clients: int, *,
                 one_hot: Optional[torch.Tensor] = None) -> Any:
    """Stage 2 from stage-1 outputs: data-size-weighted ground-station
    aggregation of the (K, ...) cluster models, broadcast to every
    client."""
    if one_hot is None:
        one_hot = membership_one_hot(assignment, k)
    dk = one_hot.T @ data_sizes.float()                           # (K,)
    return broadcast_global(global_aggregate(cluster_models, dk),
                            num_clients)


def hierarchical_round(stack, losses, data_sizes, assignment, k: int,
                       participating=None, *, do_global: bool,
                       loss_weighted: bool = True,
                       use_kernels: bool = False) -> Any:
    """One FedHC aggregation: stage 1 always, then stage 2 when
    ``do_global``, else each member gets its cluster's model.  Returns the
    new (C, ...) client-model stack."""
    num_clients = losses.shape[0]
    one_hot = membership_one_hot(assignment, k)
    w = cluster_weights(losses, data_sizes, assignment, k, participating,
                        loss_weighted=loss_weighted, one_hot=one_hot)
    cluster_models = cluster_aggregate(stack, w, assignment, k,
                                       use_kernels=use_kernels,
                                       one_hot=one_hot)
    if do_global:
        return global_round(cluster_models, data_sizes, assignment, k,
                            num_clients, one_hot=one_hot)
    return broadcast_clusters(cluster_models, assignment)
