"""Step builders for the transformer shelf: the FL train round and the
serving prefill and decode steps.  Counterpart of
``repro/launch/steps.py``.

For each (arch, input shape, mesh) a builder returns a :class:`StepBundle`:
the step function, ``in_specs`` (meta tensors: shapes and dtypes, nothing
allocated), the in/out placements from `sharding/rules.py` (``None``
without a mesh) and a ``meta`` dict.  PyTorch runs eagerly, so there is no
``jit`` around the function: a caller calls ``bundle.fn`` as it is.

The FL train step carries a leading clients dim on the parameters and
runs, each round, every client's local SGD with gradient accumulation
(reference ``:149-174``, step for step) and then FedHC's aggregation, in
one of two forms that compute the same function:

* **one device holding the (C, ...) stack** (``mesh=None``): the clients
  train one after the other, each writing its new parameters into its own
  row of the stack in place (the stack is donated, as the reference's
  launcher donates it; one client's gradients and f32 accumulator are
  live at a time), then ``core/aggregation.hierarchical_round`` over the
  stack, through the hand-written ``weighted_agg_multi`` kernel when
  ``use_kernels`` is on (the reference's ``use_pallas``).  This is the
  reference's pytree form, the oracle its shard-map step is tested
  against, and how one card holds several clients.
* **a mesh, one client per client-axis index** (``launch/mesh.py``;
  reference ``:176-205``): each rank calls ``fn`` on its own rows, (1,
  ...) of the stack and of the batch, holding its blocks of its client:
  the whole client where the client is one rank, else tensor parallelism
  over "model" and, for a pod-client arch, FSDP and the batch over "data"
  (:func:`mesh_program`, `sharding/parallel.py`; every family).  The
  aggregation is ``core/aggregation_spmd.hierarchical_agg_shard`` over
  one process group a cluster and block
  (:func:`~repro_torch.core.aggregation_spmd.make_cluster_groups`, made
  when the step is built, by every rank); with one client (a pod-client
  arch on one pod) there is nothing to aggregate, as in the reference.

The serving builders on a ``DeviceMesh`` run the same mesh program on a
rank's blocks of the parameters and caches and its rows of the batch;
on a mesh known by its shape alone they carry the placements and their
``fn`` is the one-device step.

The serving builders are thin wrappers over ``models.prefill_last`` and
``models.decode_step``.  ``launch/dryrun.py`` counts any bundle's step on
fake tensors (`launch/hlo_analysis.py`); a train step takes its ``trips``
(:func:`_trips`) so that the count runs one microbatch of one client.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, get_profile
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.runtime import RunProfile
from repro_torch.configs.shapes import InputShape
from repro_torch.core import aggregation as agg
from repro_torch.core import aggregation_spmd as spmd
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.mesh import client_axes_for, num_clients_for
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.sharding import parallel as P
from repro_torch.sharding import rules
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


class StepBundle(NamedTuple):
    fn: Any                    # step function
    in_specs: Tuple            # meta-tensor trees (positional args)
    in_shardings: Tuple        # placement trees, or Nones without a mesh
    out_shardings: Any
    meta: Dict[str, Any]


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _as_meta(tree: Any) -> Any:
    return tree_map(lambda x: _spec(x.shape, x.dtype), tree)


def _param_structs(cfg: ModelConfig) -> Any:
    """The parameter tree of ``cfg`` as meta tensors (nothing allocated:
    initialization runs under a fake-tensor mode)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        tree = M.init_params(cfg, torch.Generator())
    return _as_meta(tree)


def _stack_structs(tree: Any, n: int) -> Any:
    return tree_map(lambda s: _spec((n,) + tuple(s.shape), s.dtype), tree)


def _frontend_specs(cfg: ModelConfig, lead_shape, dtype) -> Dict[str, Any]:
    """Extra batch inputs of an audio or vision arch (stubbed front ends):
    "frames" or "patch_embeds" of (*lead_shape, frontend_len, d_model)."""
    out = {}
    if cfg.frontend == "audio":
        out["frames"] = _spec(tuple(lead_shape) + (cfg.frontend_len,
                                                   cfg.d_model), dtype)
    if cfg.frontend == "vision":
        out["patch_embeds"] = _spec(tuple(lead_shape) + (cfg.frontend_len,
                                                         cfg.d_model), dtype)
    return out


def _text_len(cfg: ModelConfig, seq_len: int) -> int:
    """The tokens of a sequence of ``seq_len`` positions: a vision prompt's
    patches take frontend_len of them."""
    return seq_len - cfg.frontend_len if cfg.frontend == "vision" else seq_len


def _resolve(arch: str, cfg: Optional[ModelConfig],
             profile: Optional[RunProfile]):
    """The arch's config and profile (or the caller's), the parameters in
    the profile's dtype, as the reference's step builds them."""
    prof = profile or get_profile(arch)
    cfg = cfg or get_config(arch)
    return dataclasses.replace(cfg, dtype=prof.param_dtype), prof


def default_clusters(num_clients: int, k: int) -> Tuple[Tuple[int, ...], ...]:
    """Static contiguous clusters (the launcher replaces these with
    k-means-derived groups via clustering.balanced_clusters)."""
    k = min(k, num_clients)
    while num_clients % k:
        k -= 1
    cap = num_clients // k
    return tuple(tuple(range(i * cap, (i + 1) * cap)) for i in range(k))


# ==========================================================================
# FL train step
# ==========================================================================

def _trips(n: int, trips=None):
    """The trips of a loop of ``n``: all of them, or, under a dry run's
    ``trips`` (`launch/dryrun.py`), the first alone inside ``trips(n)``, a
    context that counts the work done in it ``n`` times.  Every trip of
    the step's loops does the same work on the same shapes."""
    if trips is None:
        yield from range(n)
        return
    with trips(n):
        yield 0


def _local_update(cfg, p, b, *, accum: int, micro: int, lr: float,
                  acc_dt: torch.dtype, remat: bool, dispatch: str,
                  trips=None, tp=None, data_summed=None):
    """One client's local SGD step with gradient accumulation (reference
    ``local_update``): ``accum`` microbatches of ``micro`` rows, each loss
    differentiated by autograd and its gradient summed into an ``acc_dt``
    accumulator; ``new_p = (p - lr * (1/accum) * g)`` in ``acc_dt``, cast
    back to p's dtype.  Returns (new_p, loss averaged over the
    microbatches).

    On a mesh (``tp``) ``p`` is this rank's blocks (the accumulator keeps
    their sharding, as the reference's ``constrain``) and ``b`` its rows.
    Where the batch is split over "data" (a pod-client layout, FSDP) each
    rank differentiates its loss over the data size: an FSDP leaf's
    gradient comes back reduce-scattered (summed), and the leaves FSDP
    leaves whole (``data_summed``, one bool a leaf) are all-reduced over
    "data"; the loss is the mean over "data"."""
    dp = P.data_size(tp)
    leaves = tree_leaves(p)
    g_acc = [torch.zeros(x.shape, dtype=acc_dt, device=x.device)
             for x in leaves]
    l_acc = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    mbs = {k: x.reshape((accum, micro) + tuple(x.shape[1:]))
           for k, x in b.items()}
    for i in _trips(accum, trips):
        ps = [x.detach().requires_grad_(True) for x in leaves]
        loss = M.loss_fn(cfg, tree_unflatten(p, ps),
                         {k: x[i] for k, x in mbs.items()},
                         dispatch=dispatch, remat=remat, tp=tp)[0]
        grads = torch.autograd.grad(loss / dp if dp > 1 else loss, ps)
        for j, (a, g) in enumerate(zip(g_acc, grads)):
            a.add_(P.sum_over_data(tp, g.contiguous())
                   if dp > 1 and data_summed[j] else g)
        del grads                # not live beside the next microbatch
        l_acc = l_acc + loss.detach()
    if dp > 1:
        l_acc = P.sum_over_data(tp, l_acc.reshape(1))[0] / dp
    scale = 1.0 / accum
    new = [(x.to(acc_dt) - lr * scale * g).to(x.dtype)
           for x, g in zip(leaves, g_acc)]
    return tree_unflatten(p, new), l_acc * scale


def build_train_step(arch: str, shape: InputShape, mesh=None, *,
                     num_clusters: int = 4, lr: float = 0.01,
                     rounds_per_global: int = 5,
                     num_clients: Optional[int] = None,
                     clusters: Optional[Sequence[Sequence[int]]] = None,
                     use_kernels: bool = False,
                     cfg: Optional[ModelConfig] = None,
                     profile: Optional[RunProfile] = None) -> StepBundle:
    """The FL round ``fn(params_stack, batch, round_idx, *, trips=None) ->
    (params_stack, mean client loss)``: ``batch`` holds "tokens" and
    "labels" (C, pcb, S) int (S less frontend_len for a vision arch) and a
    front end's "frames" or "patch_embeds" (C, pcb, frontend_len,
    d_model), ``round_idx`` a Python int (stage-2 runs when ``(round_idx +
    1) % rounds_per_global == 0``), ``trips`` a dry run's
    (:func:`_trips`).  Without a mesh ``num_clients`` says C; on a mesh C
    is the mesh's client count and each rank passes its own rows.
    ``clusters`` (member tuples) defaults to :func:`default_clusters`.
    ``cfg`` and ``profile`` override the arch's own (a smoke variant, an
    f32 profile).  The reference's ``flat_agg`` (one all-client average a
    round) has no caller there and is not ported."""
    cfg, prof = _resolve(arch, cfg, profile)
    acc_dt = getattr(torch, prof.accum_dtype)
    if mesh is None:
        if not num_clients:
            raise ValueError("build_train_step: without a mesh, pass "
                             "num_clients (the rows of the stack)")
        n_clients, c_axes = num_clients, None
    else:
        n_clients = num_clients_for(mesh, prof.client_axis, num_clients)
        c_axes = client_axes_for(mesh, prof.client_axis)
    clusters = tuple(tuple(int(m) for m in g) for g in (
        clusters if clusters is not None
        else default_clusters(n_clients, num_clusters)))
    assignment = spmd.clusters_to_assignment(clusters, n_clients)

    # per-client batch
    if shape.global_batch % n_clients:
        raise ValueError(f"{arch} {shape.name}: global batch "
                         f"{shape.global_batch} does not split over "
                         f"{n_clients} clients")
    pcb = shape.global_batch // n_clients
    accum = min(prof.grad_accum, pcb)
    while pcb % accum:
        accum -= 1
    micro = pcb // accum

    in_specs, in_sh, out_sh = _train_specs(cfg, prof, mesh, c_axes,
                                           n_clients, pcb, shape.seq_len)

    def local(p, b, trips):
        return _local_update(cfg, p, b, accum=accum, micro=micro, lr=lr,
                             acc_dt=acc_dt, remat=prof.remat,
                             dispatch=prof.moe_dispatch, trips=trips)

    def do_global(round_idx) -> bool:
        return (int(round_idx) + 1) % rounds_per_global == 0

    if mesh is None:
        def train_step(stack, batch, round_idx, *, trips=None):
            leaves = tree_leaves(stack)
            losses = []
            for c in _trips(n_clients, trips):
                new_p, loss = local(
                    tree_unflatten(stack, [x[c] for x in leaves]),
                    {k: x[c] for k, x in batch.items()}, trips)
                for x, y in zip(leaves, tree_leaves(new_p)):
                    x[c].copy_(y)
                del new_p
                losses.append(loss)
            # a dry run's one client stands for all of them
            losses = torch.stack(losses + losses[-1:] * (n_clients
                                                         - len(losses)))
            dsize = torch.full((n_clients,), float(pcb), device=losses.device)
            stack = agg.hierarchical_round(
                stack, losses, dsize, assignment.to(losses.device),
                len(clusters), do_global=do_global(round_idx),
                use_kernels=use_kernels)
            return stack, losses.mean()
    else:
        tp = mesh_program(mesh, prof)
        table = mesh_lib.client_rank_table(mesh, c_axes)
        _check_layout(mesh, table, tp)
        groups = (spmd.make_cluster_groups(clusters, table)
                  if n_clients > 1 else None)
        # the rows of a rank: its client's, or its block of them where
        # the batch is split over "data"; every rank keeps the
        # accumulation it can (the loss and gradient are the client's)
        dp = P.data_size(tp)
        rows = pcb // dp
        rank_accum, shares = _rank_microbatches(arch, cfg, dp, pcb, accum,
                                                micro)
        if tp is not None:      # whole microbatches: a rank's own counts
            tp = dataclasses.replace(tp, rows_over_data=shares)
        specs = param_specs(cfg, prof, mesh)

        def train_step(stack, batch, round_idx, *, trips=None):
            p = tree_map(lambda x: x[0], stack)
            data_summed = [not _on_axis(s_, "data")
                           for s_ in rules.spec_leaves_like(p, specs)]
            rank_batch = {k: x[0] for k, x in batch.items()}
            if shares:
                rank_batch = _microbatch_shares(tp, rank_batch, accum, micro)
            new_p, loss = _local_update(
                cfg, p, rank_batch, accum=rank_accum,
                micro=rows // rank_accum, lr=lr, acc_dt=acc_dt,
                remat=prof.remat, dispatch=prof.moe_dispatch, trips=trips,
                tp=tp, data_summed=data_summed)
            loss = P.agree_over_model(tp, loss)
            if groups is None:             # one client: nothing to reduce
                return tree_map(lambda x: x[None], new_p), loss
            out = spmd.hierarchical_agg_shard(
                new_p, 1.0 / loss.clamp_min(1e-8), float(pcb),
                do_global(round_idx), groups=groups)
            # the mean over clients
            dist.all_reduce(loss, group=groups.across_of(dist.get_rank()))
            return tree_map(lambda x: x[None], out), loss / n_clients

    return StepBundle(
        fn=train_step,
        in_specs=in_specs,
        in_shardings=in_sh, out_shardings=out_sh,
        meta=dict(arch=arch, shape=shape.name, mode="train",
                  n_clients=n_clients, clusters=clusters, pcb=pcb,
                  accum=accum, micro=micro, dtype=prof.param_dtype,
                  use_kernels=use_kernels,
                  form="one-device" if mesh is None else "mesh",
                  **({} if mesh is None else dict(
                      rank_accum=rank_accum, rank_rows=rows,
                      microbatch_shares=shares))))


def _rank_microbatches(arch: str, cfg, dp: int, pcb: int, accum: int,
                       micro: int) -> Tuple[int, bool]:
    """(the microbatches a rank runs, whether each is its share of one of
    the client's) where the client's ``pcb`` rows are split over ``dp``
    "data" ranks, a block of ``pcb / dp`` rows each.  A MoE client's
    load-balance loss is not linear in its rows, so its microbatches are
    the reference's (``accum`` of ``micro`` rows, in row order): a rank
    whose block holds whole microbatches runs its ``accum / dp`` of them;
    where a microbatch is wider than a block and splits over "data"
    (:func:`_microbatch_shares`), each rank runs its share of every one,
    the load-balance means summed over "data"; any other layout is
    refused.  Elsewhere the loss is a mean over tokens, and each rank runs
    as many microbatches of its rows as divide them, up to ``accum``."""
    rows = pcb // dp
    if dp == 1:
        return accum, False
    if not cfg.num_experts:
        return max(a for a in range(1, min(accum, rows) + 1)
                   if rows % a == 0), False
    if rows % micro == 0:
        return rows // micro, False
    if micro % dp == 0:
        return accum, True
    raise ValueError(
        f"{arch}: {accum} microbatches of {micro} rows over {dp} \"data\" "
        f"ranks of {rows} rows: a rank holds neither whole microbatches nor "
        f"an equal share of each (its load-balance loss would not be the "
        f"reference's)")


def _microbatch_shares(tp, batch: Dict[str, torch.Tensor], accum: int,
                       micro: int) -> Dict[str, torch.Tensor]:
    """The rank's share of each of the client's ``accum`` microbatches of
    ``micro`` rows, from its block of rows (the batch's placement over
    "data"): the client's rows gathered over "data" (token ids: a few KB),
    then microbatch i's rows ``[i micro + r m, i micro + (r + 1) m)`` for
    data rank r, m = micro / data size, in microbatch order.  The union of
    the ranks' microbatch i is then the client's microbatch i, as the
    reference's step forms it."""
    dp, r = tp.data_size, tp.data_rank
    m = micro // dp
    out = {}
    for k, x in batch.items():
        full = P.all_gather(x, 0, tp.data_group, dp, r, "data")
        full = full.reshape((accum, micro) + tuple(x.shape[1:]))
        out[k] = full[:, r * m:(r + 1) * m].reshape(
            (accum * m,) + tuple(x.shape[1:]))
    return out


def _train_specs(cfg, prof, mesh, c_axes, n_clients: int, pcb: int,
                 seq_len: int):
    """The train step's ``in_specs`` (the (C, ...) stack, the batch, the
    round) and its in/out placements on ``mesh`` (Nones without one)."""
    base_params = _param_structs(cfg)
    params_structs = _stack_structs(base_params, n_clients)
    text_len = _text_len(cfg, seq_len)
    batch_structs = {k: _spec((n_clients, pcb, text_len), torch.int32)
                     for k in ("tokens", "labels")}
    batch_structs.update(_frontend_specs(cfg, (n_clients, pcb),
                                         getattr(torch, cfg.dtype)))
    in_specs = (params_structs, batch_structs, _spec((), torch.int32))
    if mesh is None:
        return in_specs, (None, None, None), (None, None)
    pspec = _specs_of(base_params, prof, mesh)
    params_sh = rules.tree_shardings(_stacked_specs(pspec, c_axes), mesh)
    batch_axis = None if prof.client_axis == "data" else "data"
    batch_sh = {k: rules.placements(rules.P(c_axes, batch_axis), mesh)
                for k in batch_structs}
    return (in_specs,
            (params_sh, batch_sh, rules.placements(rules.P(), mesh)),
            (params_sh, rules.placements(rules.P(), mesh)))


def train_placements(arch: str, shape: InputShape, mesh, *,
                     cfg: Optional[ModelConfig] = None,
                     profile: Optional[RunProfile] = None):
    """``(in_specs, in_shardings)`` of the train step on ``mesh`` without
    building the step (a mesh known by its shape alone: no process group,
    no cluster groups)."""
    cfg, prof = _resolve(arch, cfg, profile)
    n_clients = num_clients_for(mesh, prof.client_axis)
    c_axes = client_axes_for(mesh, prof.client_axis)
    in_specs, in_sh, _ = _train_specs(cfg, prof, mesh, c_axes, n_clients,
                                      shape.global_batch // n_clients,
                                      shape.seq_len)
    return in_specs, in_sh


def _stacked_specs(pspec, c_axes):
    """Each leaf's spec with the clients dim in front."""
    if isinstance(pspec, rules.PartitionSpec):
        return pspec.lead(c_axes)
    if isinstance(pspec, dict):
        return {k: _stacked_specs(v, c_axes) for k, v in pspec.items()}
    return tuple(_stacked_specs(v, c_axes) for v in pspec)


def _specs_of(params, prof, mesh):
    fsdp = "data" if prof.client_axis == "pod" else None
    return rules.tree_param_specs(params, mesh, tp_axes="model",
                                  fsdp_axes=fsdp)


def param_specs(cfg, prof, mesh):
    """The placement specs of one client's (or the served model's)
    leaves on ``mesh``: `tp` over "model", `fsdp` over "data" for a
    pod-client arch (`rules.local_shard` cuts a rank's blocks by
    them)."""
    return _specs_of(_param_structs(cfg), prof, mesh)


def _on_axis(spec, axis: str) -> bool:
    return any(e == axis or (isinstance(e, tuple) and axis in e)
               for e in spec)


def mesh_program(mesh, prof):
    """This rank's `sharding/parallel.TP` on a ``DeviceMesh`` whose
    "model" axis is above 1 or whose "data" axis shards a pod-client
    arch's parameters (FSDP); None where no collective runs inside a
    client or replica (no mesh, a "model" size of 1 without FSDP) or the
    mesh is known by its shape alone (its bundle carries placements; its
    ``fn`` is the one-device step).  With FSDP a served batch is split
    over "data" (``rows_over_data``); the train step and a decode step
    whose batch does not split say otherwise."""
    if mesh is None or not hasattr(mesh, "get_group"):
        return None
    sizes = rules.mesh_shape(mesh)
    fsdp = prof.client_axis == "pod" and sizes.get("data", 1) > 1
    if sizes.get("model", 1) == 1 and not fsdp:
        return None
    return P.TP.from_mesh(mesh, fsdp=fsdp)


def _check_layout(mesh, table, tp) -> None:
    """One client per client-axis index, its blocks on the other axes:
    the world is the mesh, and a client spread over several ranks runs the
    mesh program on a ``DeviceMesh``."""
    shape = rules.mesh_shape(mesh)
    world = dist.get_world_size()
    if world != sum(len(row) for row in table):
        raise ValueError(f"mesh {shape}: {len(table)} clients of "
                         f"{len(table[0])} ranks each, on {world} ranks; "
                         f"the train step takes one client per client-axis "
                         f"index")
    if len(table[0]) > 1:
        if tp is None:
            raise ValueError(f"mesh {shape}: a client on {len(table[0])} "
                             f"ranks needs a DeviceMesh (launch/mesh.py)")


# ==========================================================================
# Serving steps (prefill / decode)
# ==========================================================================

def _serve_param_shardings(prof, mesh, base_params):
    if mesh is None:
        return None
    return rules.tree_shardings(_specs_of(base_params, prof, mesh), mesh)


def _batch_axes(mesh, batch: int, fallback):
    if mesh is None:
        return None
    names = rules.mesh_shape(mesh)
    axes = ("pod", "data") if "pod" in names else "data"
    return axes if batch % rules.axis_size(mesh, axes) == 0 else fallback


def cache_spec_tree(cache_structs, batch_axes, mesh):
    """Cache placement specs: the batch dim over ``batch_axes``; the
    attention cache's sequence dim over "model" where it divides; a
    recurrent layer's state over "model" as its parameters are
    (`sharding/rules.py`): the SSD's (B, H, P, N) ``h`` by heads and its
    (B, K-1, d_inner + 2N) ``conv`` part by part (the rank's x channels,
    all of B and C), the RG-LRU's (B, W) ``h`` and (B, K-1, W) ``conv``
    by channels, each where its heads or width divide.  Caches under
    "layers" are stacked with a leading cycles dim (those under
    "rem_layers" are not), told from the path, never from ndim."""
    msize = rules.mesh_shape(mesh)["model"]

    def walk(tree, keys):
        if isinstance(tree, dict) and set(tree) == {"h", "conv"}:
            lead = (None,) * (1 if keys and keys[0] == "layers" else 0)
            h, conv = tree["h"].shape[len(lead):], tree["conv"].shape[-1]
            ssd = len(h) == 4                   # (B, H, P, N), not (B, W)
            if msize == 1 or (h[1] if ssd else conv) % msize:
                return {"h": rules.P(*lead, batch_axes),
                        "conv": rules.P(*lead, batch_axes)}
            cuts = (rules.ssd_channel_cuts(h[1] * h[2], conv - h[1] * h[2])
                    if ssd else ())
            return {"h": rules.P(*lead, batch_axes, "model"),
                    "conv": rules.P(*lead, batch_axes, None, "model",
                                    cuts=cuts)}
        if isinstance(tree, dict):
            return {k: walk(v, keys + (str(k),)) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return tuple(walk(v, keys + (str(i),)) for i, v in enumerate(tree))
        name = keys[-1]
        if name == "slot_pos":
            return rules.P()
        lead = 1 if keys and keys[0] == "layers" else 0
        if name in ("k", "v", "k_scale", "v_scale"):
            # (B, L, H, D) / (B, L, H)
            seq_ax = "model" if tree.shape[lead + 1] % msize == 0 else None
            return rules.P(*((None,) * lead), batch_axes, seq_ax)
        raise ValueError(f"cache leaf {'/'.join(keys)}")

    return walk(cache_structs, ())


def _cache_structs(cfg, prof, batch: int, max_len: int):
    """The cache tree (int8 with scales under ``prof.kv_int8``) as meta
    tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        caches = T.init_caches(cfg, batch, max_len, getattr(torch, cfg.dtype),
                               torch.device("cpu"), quantized=prof.kv_int8)
    return _as_meta(caches)


def build_prefill_step(arch: str, shape: InputShape, mesh=None, *,
                       cfg: Optional[ModelConfig] = None,
                       profile: Optional[RunProfile] = None) -> StepBundle:
    """``fn(params, batch) -> (last-position logits (B, V), caches)`` over
    caches of ``shape.seq_len``, with the profile's MoE dispatch and KV
    cache (int8 under ``kv_int8``).  ``batch`` holds "tokens" (B, S; S
    less frontend_len for a vision arch, whose patches take the rest of
    the positions) and a front end's "frames" or "patch_embeds"."""
    cfg, prof = _resolve(arch, cfg, profile)
    B, S = shape.global_batch, shape.seq_len
    batch_axes = _batch_axes(mesh, B, "data")
    base_params = _param_structs(cfg)
    cache_structs = _cache_structs(cfg, prof, B, S)
    batch_structs = {"tokens": _spec((B, _text_len(cfg, S)), torch.int32)}
    batch_structs.update(_frontend_specs(cfg, (B,),
                                         getattr(torch, cfg.dtype)))

    tp = mesh_program(mesh, prof)

    def prefill_step(params, batch):
        return M.prefill_last(cfg, params, batch, S,
                              dispatch=prof.moe_dispatch,
                              quantized_cache=prof.kv_int8, tp=tp)

    if mesh is None:
        in_sh, out_sh = (None, None), (None, None)
    else:
        in_sh = (_serve_param_shardings(prof, mesh, base_params),
                 {k: rules.placements(rules.P(batch_axes), mesh)
                  for k in batch_structs})
        out_sh = (rules.placements(rules.P(batch_axes, "model"), mesh),
                  rules.tree_shardings(
                      cache_spec_tree(cache_structs, batch_axes, mesh), mesh))
    return StepBundle(
        fn=prefill_step, in_specs=(base_params, batch_structs),
        in_shardings=in_sh, out_shardings=out_sh,
        meta=dict(arch=arch, shape=shape.name, mode="prefill",
                  batch_axes=batch_axes, dtype=cfg.dtype))


def build_decode_step(arch: str, shape: InputShape, mesh=None, *,
                      cfg: Optional[ModelConfig] = None,
                      profile: Optional[RunProfile] = None) -> StepBundle:
    """``fn(params, caches, token (B, 1), pos[, enc_out]) -> (logits (B,
    V), caches)``, the caches written in place, with the profile's MoE
    dispatch; the caches are int8 under ``kv_int8``.  An enc-dec arch
    takes a fifth input, the encoder's output ``enc_out`` (B,
    frontend_len, d_model)."""
    cfg, prof = _resolve(arch, cfg, profile)
    B, S = shape.global_batch, shape.seq_len
    # long_500k has batch 1: the batch dim replicated
    batch_axes = _batch_axes(mesh, B, None)
    base_params = _param_structs(cfg)
    cache_structs = _cache_structs(cfg, prof, B, S)

    tp = mesh_program(mesh, prof)
    if tp is not None and batch_axes is None:    # every rank all the rows
        tp = dataclasses.replace(tp, rows_over_data=False)

    def decode_step(params, caches, token, pos, enc_out=None):
        logits, caches = M.decode_step(cfg, params, caches, token, pos,
                                       enc_out=enc_out,
                                       dispatch=prof.moe_dispatch, tp=tp)
        return logits[:, 0], caches

    in_specs = [base_params, cache_structs, _spec((B, 1), torch.int32),
                _spec((), torch.int32)]
    if cfg.is_enc_dec:
        in_specs.append(_spec((B, cfg.frontend_len, cfg.d_model),
                              getattr(torch, cfg.dtype)))
    if mesh is None:
        in_sh, out_sh = (None,) * len(in_specs), (None, None)
    else:
        cache_sh = rules.tree_shardings(
            cache_spec_tree(cache_structs, batch_axes, mesh), mesh)
        in_sh = (_serve_param_shardings(prof, mesh, base_params), cache_sh,
                 rules.placements(rules.P(batch_axes), mesh),
                 rules.placements(rules.P(), mesh))
        if cfg.is_enc_dec:
            in_sh += (rules.placements(rules.P(batch_axes), mesh),)
        out_sh = (rules.placements(rules.P(batch_axes, "model"), mesh),
                  cache_sh)
    return StepBundle(
        fn=decode_step, in_specs=tuple(in_specs),
        in_shardings=in_sh, out_shardings=out_sh,
        meta=dict(arch=arch, shape=shape.name, mode="decode",
                  batch_axes=batch_axes, dtype=cfg.dtype))


def build_step(arch: str, shape: InputShape, mesh=None, **kw) -> StepBundle:
    if shape.mode == "train":
        return build_train_step(arch, shape, mesh, **kw)
    serve_kw = {k: kw[k] for k in ("cfg", "profile") if k in kw}
    if shape.mode == "prefill":
        return build_prefill_step(arch, shape, mesh, **serve_kw)
    return build_decode_step(arch, shape, mesh, **serve_kw)
