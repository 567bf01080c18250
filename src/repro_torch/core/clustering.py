"""Satellite-clustered parameter-server selection (paper §III-B).

Counterpart of ``repro/core/clustering.py``: k-means over position vectors
(Eq. 13 assignment, Eq. 14 centroid update, Eq. 15 convergence test) for a
fixed iteration count with a convergence mask, then the satellite nearest
each centroid becomes that cluster's PS.  The expanded distance formula is
kept, so argmin decisions round as the reference's do.  The initial
centroid indices are the caller's (``torch.randperm(n, generator=g)[:k]``
natively, or the reference's draws in the parity tests).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class ClusterResult(NamedTuple):
    centroids: torch.Tensor    # (K, dims)
    assignment: torch.Tensor   # (N,) int32 cluster id per satellite
    ps_index: torch.Tensor     # (K,) int32 satellite index chosen as PS
    iterations: torch.Tensor   # () int32 iterations until Eq. 15 fired


def pairwise_sq_dist(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Eq. 13 (squared): x (N,D), c (K,D) -> (N,K)."""
    return ((x * x).sum(-1)[:, None] - 2.0 * x @ c.T
            + (c * c).sum(-1)[None, :])


def assign(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    return torch.argmin(pairwise_sq_dist(x, centroids), dim=1).to(torch.int32)


def update_centroids(x, assignment, centroids):
    """Eq. 14; empty clusters keep their previous centroid."""
    k = centroids.shape[0]
    one_hot = F.one_hot(assignment.long(), k).to(x.dtype)         # (N,K)
    counts = one_hot.sum(0)                                       # (K,)
    sums = one_hot.T @ x                                          # (K,D)
    return torch.where(counts[:, None] > 0,
                       sums / counts.clamp_min(1.0)[:, None], centroids)


def ps_select(positions, centroids, assignment, k: int) -> torch.Tensor:
    """Per cluster, the member nearest its centroid (masked argmin; an
    empty cluster gets index 0, as ``jnp.argmin`` over all-inf does)."""
    d = pairwise_sq_dist(positions, centroids)
    same = F.one_hot(assignment.long(), k).bool().T               # (K,N)
    masked = torch.where(same, d.T, torch.inf)
    return torch.argmin(masked, dim=1).to(torch.int32)


def kmeans(positions: torch.Tensor, k: int, init_idx: torch.Tensor,
           iters: int = 32, tol: float = 1e-4) -> ClusterResult:
    """positions (N, D) -> ClusterResult, from the centroids
    ``positions[init_idx]``.  Runs all ``iters`` steps on the device; once
    Eq. 15 fires the centroids stop moving (no host sync)."""
    c = positions[init_idx.long()]
    done = torch.zeros((), dtype=torch.bool, device=positions.device)
    it = torch.zeros((), dtype=torch.int32, device=positions.device)
    for _ in range(iters):
        a = assign(positions, c)
        c_new = update_centroids(positions, a, c)
        shift = ((c_new - c) ** 2).sum()                          # Eq. 15
        it = it + (~done).to(torch.int32)
        c = torch.where(done, c, c_new)
        done = done | (shift < tol)
    a = assign(positions, c)
    return ClusterResult(c, a, ps_select(positions, c, a, k), it)


def dropout_rate(participating: torch.Tensor, assignment: torch.Tensor,
                 k: int) -> torch.Tensor:
    """Alg. 1 line 15: d_r = C^d / C^k per cluster."""
    one_hot = F.one_hot(assignment.long(), k).float()
    total = one_hot.sum(0)
    dropped = (one_hot * (~participating).float()[:, None]).sum(0)
    return dropped / total.clamp_min(1.0)
