"""SPMD form of FedHC's two-stage aggregation over ``torch.distributed``.

Counterpart of ``repro/core/aggregation_spmd.py``.  The reference keeps a
global view of the (C, ...) client stack and lets GSPMD place it; here one
process a rank holds rows ``[r*C/W, (r+1)*C/W)`` (:class:`ClientShard`)
and the collectives are explicit:

* **Stage 1 under the mesh** (:func:`hierarchical_round_sharded`,
  :func:`buffered_flush_sharded`): every rank holds the full (C,) losses,
  participation and data sizes (the engines gather them once a round), so
  it computes the full (C, K) weight matrix exactly as one device does;
  it then reduces its own (C/W, P) rows against its own (C/W, K) rows of
  that matrix, through ``ops.weighted_agg_multi_tree`` when the kernels
  are on, and one ``all_reduce(SUM)`` of the (K, P) partials gives the
  cluster models on every rank.  Stage 2 (``global_round``) or
  ``broadcast_clusters`` then writes the rank's own rows.  Only the order
  of the stage-1 sum differs from one device, and at W = 1 nothing does.
  The assignment is data: a re-clustering creates no process group.
* **Gathers are all-reduces** (:meth:`ClientShard.gather`): a rank writes
  its rows into zeros and the sum fills the rest, exactly (``x + 0``).
  ``gloo`` takes only ``all_reduce`` and ``broadcast`` of CUDA tensors, so
  the client mesh uses no other collective, on any backend.
* :func:`hierarchical_agg_shard` is the body of the static-layout
  transformer step (``launch/steps.py``), one client a rank or, on a
  mesh whose "model" (or a pod-client layout's "data") axis is above 1,
  one block of a client a rank: the reference's
  ``psum(axis_index_groups=clusters)`` is an ``all_reduce`` over one
  process group a (cluster, block) (:func:`make_cluster_groups`, made
  once, by every rank), stage 2 an ``all_reduce`` of the
  representatives' ``x * D_k`` over every client's rank of the block
  (the world where a client is one rank).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import aggregation as agg
from repro_torch.launch import mesh as mesh_lib
from repro_torch.sharding import parallel as P
from repro_torch.sharding.rules import mesh_shape
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclass(frozen=True)
class ClientShard:
    """This rank's rows of a (C, ...) client-stacked array on a 1-D client
    mesh, and the collectives over its process group."""
    group: Any                 # the mesh's process group
    rank: int
    world: int
    num_clients: int

    @property
    def rows(self) -> int:
        return self.num_clients // self.world

    @property
    def lo(self) -> int:
        return self.rank * self.rows

    @property
    def hi(self) -> int:
        return self.lo + self.rows

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a full (C, ...) tensor."""
        return x[self.lo:self.hi]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Full (C, ...) float32 from every rank's (C/W, ...) rows: each
        rank writes its rows into zeros and the sum over ranks fills the
        rest, exactly.  (``-0.0`` comes back as ``0.0``.)"""
        full = torch.zeros((self.num_clients,) + tuple(x.shape[1:]),
                           dtype=torch.float32, device=x.device)
        full[self.lo:self.hi] = x
        dist.all_reduce(full, group=self.group)
        return full

    def gather_vectors(self, *vectors: torch.Tensor) -> torch.Tensor:
        """(n, C) float32 from n of this rank's (C/W,) vectors, in one
        gather; each row is contiguous, so a reduction over it sums in the
        one-device vector's order (a strided column would not)."""
        return self.gather(torch.stack([v.float() for v in vectors],
                                       1)).T.contiguous()

    def sum_tree(self, tree: Any) -> Any:
        """Elementwise sum of a float32 tree over the ranks, in one
        ``all_reduce`` of the leaves laid end to end."""
        leaves = tree_leaves(tree)
        flat = torch.cat([x.reshape(-1) for x in leaves])
        dist.all_reduce(flat, group=self.group)
        out, at = [], 0
        for x in leaves:
            out.append(flat[at:at + x.numel()].view(x.shape))
            at += x.numel()
        return tree_unflatten(tree, out)

    def mean_rows(self, stack: Any) -> Any:
        """Mean over all C rows of a client-stacked tree: each rank's row
        mean, weighted by its share (1/W) and summed (at W = 1 the
        one-device ``x.float().mean(0)``, bit for bit)."""
        share = self.rows / self.num_clients
        return self.sum_tree(tree_map(lambda x: x.float().mean(0) * share,
                                      stack))

    def agree(self, x: torch.Tensor) -> torch.Tensor:
        """Rank 0's value of ``x`` on every rank: a decision the host
        reads, so every rank takes the same branch (and the same
        collectives) even if the replicated inputs differed by a bit."""
        x = x.clone()
        dist.broadcast(x, src=dist.get_global_rank(self.group, 0),
                       group=self.group)
        return x

    def ps_rows(self, tpb_local: torch.Tensor,
                ps_index: torch.Tensor) -> torch.Tensor:
        """The (K, N) rows ``ps_index`` of a row-sharded (N, N) table:
        each PS's owner contributes its row, the others zeros."""
        idx = ps_index.long()
        mine = (idx >= self.lo) & (idx < self.hi)
        local = (idx - self.lo).clamp(0, self.rows - 1)
        rows = tpb_local.index_select(0, local)
        rows = torch.where(mine[:, None], rows, 0.0).float()
        dist.all_reduce(rows, group=self.group)
        return rows


def agreed(shard: Optional[ClientShard], x: torch.Tensor) -> torch.Tensor:
    """``x`` about to be read on the host: rank 0's value on a client
    mesh (:meth:`ClientShard.agree`), ``x`` itself without one."""
    return x if shard is None else shard.agree(x)


def client_shard(mesh, num_clients: int, client_axes=None) -> ClientShard:
    """The calling rank's :class:`ClientShard` on a 1-D client mesh whose
    one axis carries the clients (``client_axes`` None, that axis, or a
    1-tuple of it); raises unless ``num_clients`` divides the axis."""
    names = tuple(mesh_shape(mesh))
    if len(names) != 1:
        raise ValueError(f"the FL engines shard over a 1-D client mesh; "
                         f"got axes {names}")
    caxes = names if client_axes is None else (
        (client_axes,) if isinstance(client_axes, str)
        else tuple(client_axes))
    if caxes != names:
        raise ValueError(f"client_axes {caxes} must be the client mesh's "
                         f"one axis {names}")
    mesh_lib.validate_client_sharding(mesh, caxes, num_clients)
    group = mesh.get_group()
    return ClientShard(group=group, rank=dist.get_rank(group),
                       world=dist.get_world_size(group),
                       num_clients=num_clients)


def cluster_aggregate_sharded(stack: Any, weights: torch.Tensor,
                              assignment: torch.Tensor, k: int,
                              shard: ClientShard, *,
                              use_kernels: bool = False,
                              one_hot: Optional[torch.Tensor] = None) -> Any:
    """Stage 1 on this rank's rows: full (C,) ``weights`` and
    ``assignment``, the local (C/W, ...) ``stack``; returns the (K, ...)
    cluster models on every rank."""
    if one_hot is None:
        one_hot = agg.membership_one_hot(assignment, k)
    partial = agg.cluster_aggregate(
        stack, shard.local(weights), shard.local(assignment), k,
        use_kernels=use_kernels, one_hot=shard.local(one_hot))
    dtypes = tree_map(lambda x: x.dtype, partial)
    summed = shard.sum_tree(tree_map(lambda x: x.float(), partial))
    return tree_map(lambda x, d: x.to(d), summed, dtypes)


def hierarchical_round_sharded(stack, losses, data_sizes, assignment, k: int,
                               do_global: bool, *, shard: ClientShard,
                               loss_weighted: bool = True,
                               participating=None,
                               use_kernels: bool = False) -> Any:
    """One FedHC aggregation on a client mesh: ``stack`` is this rank's
    (C/W, ...) rows; ``losses``, ``data_sizes``, ``assignment`` and
    ``participating`` are full (C,).  The math of
    ``aggregation.hierarchical_round``; returns this rank's new rows."""
    one_hot = agg.membership_one_hot(assignment, k)
    w = agg.cluster_weights(losses, data_sizes, assignment, k, participating,
                            loss_weighted=loss_weighted, one_hot=one_hot)
    cluster_models = cluster_aggregate_sharded(
        stack, w, assignment, k, shard, use_kernels=use_kernels,
        one_hot=one_hot)
    if do_global:
        return agg.global_round(cluster_models, data_sizes, assignment, k,
                                shard.rows, one_hot=one_hot)
    return agg.broadcast_clusters(cluster_models, shard.local(assignment))


def buffered_flush_sharded(contrib_stack, losses, data_sizes, assignment,
                           k: int, contrib_w, flush, cluster_params, *,
                           shard: ClientShard, loss_weighted: bool = True,
                           server_lr: float = 1.0,
                           use_kernels: bool = False) -> Any:
    """The async flush (``aggregation.buffered_flush``) on a client mesh:
    ``contrib_stack`` is this rank's rows, ``losses``, ``data_sizes``,
    ``assignment`` and ``contrib_w`` full (C,); the (K, ...) cluster
    models come back on every rank."""
    one_hot = agg.membership_one_hot(assignment, k)
    w = agg.cluster_weights(losses, data_sizes, assignment, k,
                            participating=contrib_w,
                            loss_weighted=loss_weighted, one_hot=one_hot)
    new_models = cluster_aggregate_sharded(
        contrib_stack, w, assignment, k, shard, use_kernels=use_kernels,
        one_hot=one_hot)
    return agg.mix_flushed(new_models, cluster_params, flush, server_lr)


def clusters_to_assignment(clusters: Sequence[Sequence[int]],
                           num_clients: Optional[int] = None, *,
                           device=None) -> torch.Tensor:
    """Static cluster groups (tuple of member tuples) -> (C,) int32."""
    if num_clients is None:
        num_clients = sum(len(g) for g in clusters)
    a = torch.full((num_clients,), -1, dtype=torch.int32)
    for cid, members in enumerate(clusters):
        for m in members:
            a[m] = cid
    if (a < 0).any():
        missing = torch.nonzero(a < 0).flatten().tolist()
        raise ValueError(f"clients {missing} appear in no cluster group")
    return a.to(device) if device is not None else a


@dataclass(frozen=True)
class ClusterGroups:
    """The process groups of a static cluster layout, made once
    (:func:`make_cluster_groups`): one a (cluster, within-client block),
    over the ranks that hold that block of the cluster's clients, and one
    a block over every client's rank of it (stage 2; ``None``, the world,
    where a client is one rank).  ``table[c][j]`` is the rank holding
    block ``j`` of client ``c``."""
    clusters: Tuple[Tuple[int, ...], ...]
    groups: Tuple[Any, ...]              # [cluster * blocks + block]
    table: Tuple[Tuple[int, ...], ...]
    across: Tuple[Any, ...]              # [block]

    @property
    def blocks(self) -> int:
        return len(self.table[0])

    @property
    def reps(self) -> Tuple[int, ...]:
        """The ranks of each cluster's first member (every block)."""
        return tuple(self.table[g[0]][j] for g in self.clusters
                     for j in range(self.blocks))

    def _where(self, rank: int) -> Tuple[int, int]:
        for c, row in enumerate(self.table):
            if rank in row:
                return c, row.index(rank)
        raise ValueError(f"rank {rank} holds no client")

    def of(self, rank: int) -> Any:
        """The stage-1 group of ``rank``."""
        c, j = self._where(rank)
        for k, members in enumerate(self.clusters):
            if c in members:
                return self.groups[k * self.blocks + j]
        raise ValueError(f"rank {rank} is in no cluster group")

    def across_of(self, rank: int) -> Any:
        """The stage-2 group of ``rank``: its block of every client."""
        return self.across[self._where(rank)[1]]


def make_cluster_groups(clusters: Sequence[Sequence[int]],
                        table: Optional[Sequence[Sequence[int]]] = None
                        ) -> ClusterGroups:
    """Create the process groups of a static cluster layout.  Every rank
    calls it with the same arguments, in the same order (``dist.new_group``
    is collective).  ``table[c][j]`` is the rank holding within-client
    block ``j`` of client ``c`` (`launch/mesh.client_rank_table`; default,
    one client a rank: ``[[0], [1], ...]``).  On a mesh whose "model"
    axis (or, for a pod-client layout, "data" axis) is above 1 each
    client's blocks average their own shard: one group a (cluster,
    block), formed over the ranks that hold the same shard of different
    clients."""
    clusters = tuple(tuple(int(m) for m in g) for g in clusters)
    if table is None:
        table = [[r] for r in range(dist.get_world_size())]
    table = tuple(tuple(int(r) for r in row) for row in table)
    clusters_to_assignment(clusters, len(table))
    blocks = len(table[0])
    groups = tuple(dist.new_group([table[c][j] for c in g])
                   for g in clusters for j in range(blocks))
    across = ((None,) if blocks == 1 and
              len(table) == dist.get_world_size() else
              tuple(dist.new_group([row[j] for row in table])
                    for j in range(blocks)))
    return ClusterGroups(clusters, groups, table, across)


def hierarchical_agg_shard(local_params, inv_loss, data_size, do_global: bool,
                           *, groups: ClusterGroups) -> Any:
    """Body for one client a rank, or one within-client block a rank.

    local_params: this client's model tree (no clients dim), or this
                  rank's blocks of it.
    inv_loss:     scalar 1/L_i (Eq. 12 numerator), the same on every
                  rank of a client.
    data_size:    scalar |D_i|.
    do_global:    the same bool on every rank (a ground-station round).

    Returns this client's new model (block): its cluster's loss-weighted
    average (Eq. 5 + Eq. 12), or, when ``do_global``, the
    data-size-weighted average of the cluster models that the
    representatives (each cluster's first member) hold."""
    leaves = tree_leaves(local_params)
    dev = leaves[0].device
    w = torch.as_tensor(inv_loss, dtype=torch.float32, device=dev)
    dsz = torch.as_tensor(data_size, dtype=torch.float32, device=dev)
    rank = dist.get_rank()

    # ---- stage 1: intra-cluster loss-weighted average, and D_k -------------
    sizes = [x.numel() for x in leaves]
    # one f32 buffer, filled a leaf at a time (x * w, then w and D_i)
    flat = torch.empty(sum(sizes) + 2, dtype=torch.float32, device=dev)
    at = 0
    for x, n in zip(leaves, sizes):
        flat[at:at + n].copy_(x.reshape(-1)).mul_(w)
        at += n
    flat[-2:] = torch.stack([w, dsz])
    P.all_reduce(flat, groups.of(rank), "clients")
    num, den, dk = flat[:-2], flat[-2], flat[-1]
    model = num / den.clamp_min(1e-12)

    # ---- stage 2: ground-station aggregation across the cluster PSs -------
    if do_global:
        is_rep = rank in groups.reps
        contrib = torch.cat([model * dk, dk.reshape(1)])
        if not is_rep:
            contrib = torch.zeros_like(contrib)
        P.all_reduce(contrib, groups.across_of(rank), "clients")
        model = contrib[:-1] / contrib[-1].clamp_min(1e-12)

    out, at = [], 0
    for x, n in zip(leaves, sizes):
        out.append(model[at:at + n].view(x.shape).to(x.dtype))
        at += n
    return tree_unflatten(local_params, out)


def make_spmd_aggregator(mesh, client_axes,
                         clusters: Tuple[Tuple[int, ...], ...]):
    """An aggregator over a client-stacked tree on ``mesh``, static
    cluster groups given as member tuples: ``fn(stack, inv_loss,
    data_size, do_global)`` takes this rank's rows of each (``inv_loss``
    is Eq. 12's 1/L_i) and returns this rank's new rows, through
    :func:`hierarchical_round_sharded`."""
    axes = ((client_axes,) if isinstance(client_axes, str)
            else tuple(client_axes))
    names = tuple(mesh_shape(mesh))
    missing = [a for a in axes if a not in names]
    if missing:
        raise ValueError(f"client_axes {missing} not in mesh axes {names}")
    k = len(clusters)
    num_clients = sum(len(g) for g in clusters)
    shard = client_shard(mesh, num_clients, axes)
    assignment = clusters_to_assignment(clusters, num_clients)

    def fn(stack, inv_loss, data_size, do_global):
        inv_all, sizes_all = shard.gather_vectors(inv_loss, data_size)
        losses = 1.0 / inv_all.clamp_min(1e-12)
        return hierarchical_round_sharded(
            stack, losses, sizes_all, assignment.to(inv_all.device), k,
            bool(do_global), shard=shard, loss_weighted=True)

    return fn
