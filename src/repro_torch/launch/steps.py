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
* **a client mesh, one client a rank** (``launch/mesh.py``; reference
  ``:176-205``): each rank calls ``fn`` on its own rows, (1, ...) of the
  stack and of the batch, and the aggregation is
  ``core/aggregation_spmd.hierarchical_agg_shard`` over one process group
  a cluster (:func:`~repro_torch.core.aggregation_spmd.make_cluster_groups`,
  made when the step is built, by every rank).  The port has no tensor
  parallelism, so the mesh's "model" axis must have size 1.

The serving builders are thin wrappers over ``models.prefill_last`` and
``models.decode_step``.  A dry run (lower and compile, then the reference's
``hlo_analysis``) is slice 16b's.
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
from repro_torch.launch.mesh import client_axes_for, num_clients_for
from repro_torch.models import model as M
from repro_torch.models import transformer as T
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

def _local_update(cfg, p, b, *, accum: int, micro: int, lr: float,
                  acc_dt: torch.dtype, remat: bool, dispatch: str):
    """One client's local SGD step with gradient accumulation (reference
    ``local_update``): ``accum`` microbatches of ``micro`` rows, each loss
    differentiated by autograd and its gradient summed into an ``acc_dt``
    accumulator; ``new_p = (p - lr * (1/accum) * g)`` in ``acc_dt``, cast
    back to p's dtype.  Returns (new_p, loss averaged over the
    microbatches)."""
    leaves = tree_leaves(p)
    g_acc = [torch.zeros(x.shape, dtype=acc_dt, device=x.device)
             for x in leaves]
    l_acc = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    mbs = {k: x.reshape((accum, micro) + tuple(x.shape[1:]))
           for k, x in b.items()}
    for i in range(accum):
        ps = [x.detach().requires_grad_(True) for x in leaves]
        loss = M.loss_fn(cfg, tree_unflatten(p, ps),
                         {k: x[i] for k, x in mbs.items()},
                         dispatch=dispatch, remat=remat)[0]
        for a, g in zip(g_acc, torch.autograd.grad(loss, ps)):
            a.add_(g)
        l_acc = l_acc + loss.detach()
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
    """The FL round ``fn(params_stack, batch, round_idx) -> (params_stack,
    mean client loss)``: ``batch`` holds "tokens" and "labels" (C, pcb, S)
    int (S less frontend_len for a vision arch) and a front end's "frames"
    or "patch_embeds" (C, pcb, frontend_len, d_model), ``round_idx`` a
    Python int (stage-2 runs when ``(round_idx + 1) %
    rounds_per_global == 0``).  Without a mesh ``num_clients`` says C; on
    a mesh C is the mesh's client count and each rank passes its own rows.
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

    # ---- specs and placements ---------------------------------------------
    base_params = _param_structs(cfg)
    params_structs = _stack_structs(base_params, n_clients)
    text_len = _text_len(cfg, shape.seq_len)
    batch_structs = {k: _spec((n_clients, pcb, text_len), torch.int32)
                     for k in ("tokens", "labels")}
    batch_structs.update(_frontend_specs(cfg, (n_clients, pcb),
                                         getattr(torch, cfg.dtype)))
    round_struct = _spec((), torch.int32)
    if mesh is None:
        in_sh, out_sh = (None, None, None), (None, None)
    else:
        fsdp = "data" if prof.client_axis == "pod" else None
        pspec = rules.tree_param_specs(base_params, mesh, tp_axes="model",
                                       fsdp_axes=fsdp)
        params_sh = rules.tree_shardings(_stacked_specs(pspec, c_axes), mesh)
        batch_axis = None if prof.client_axis == "data" else "data"
        batch_sh = {k: rules.placements(rules.P(c_axes, batch_axis), mesh)
                    for k in batch_structs}
        in_sh = (params_sh, batch_sh, rules.placements(rules.P(), mesh))
        out_sh = (params_sh, rules.placements(rules.P(), mesh))

    def local(p, b):
        return _local_update(cfg, p, b, accum=accum, micro=micro, lr=lr,
                             acc_dt=acc_dt, remat=prof.remat,
                             dispatch=prof.moe_dispatch)

    def do_global(round_idx) -> bool:
        return (int(round_idx) + 1) % rounds_per_global == 0

    if mesh is None:
        def train_step(stack, batch, round_idx):
            leaves = tree_leaves(stack)
            losses = []
            for c in range(n_clients):
                new_p, loss = local(
                    tree_unflatten(stack, [x[c] for x in leaves]),
                    {k: x[c] for k, x in batch.items()})
                for x, y in zip(leaves, tree_leaves(new_p)):
                    x[c].copy_(y)
                del new_p
                losses.append(loss)
            losses = torch.stack(losses)
            dsize = torch.full((n_clients,), float(pcb), device=losses.device)
            stack = agg.hierarchical_round(
                stack, losses, dsize, assignment.to(losses.device),
                len(clusters), do_global=do_global(round_idx),
                use_kernels=use_kernels)
            return stack, losses.mean()
    else:
        _check_one_client_a_rank(mesh, n_clients)
        groups = spmd.make_cluster_groups(clusters)

        def train_step(stack, batch, round_idx):
            new_p, loss = local(tree_map(lambda x: x[0], stack),
                                {k: x[0] for k, x in batch.items()})
            out = spmd.hierarchical_agg_shard(
                new_p, 1.0 / loss.clamp_min(1e-8), float(pcb),
                do_global(round_idx), groups=groups)
            dist.all_reduce(loss)                 # the mean over clients
            return tree_map(lambda x: x[None], out), loss / n_clients

    return StepBundle(
        fn=train_step,
        in_specs=(params_structs, batch_structs, round_struct),
        in_shardings=in_sh, out_shardings=out_sh,
        meta=dict(arch=arch, shape=shape.name, mode="train",
                  n_clients=n_clients, clusters=clusters, pcb=pcb,
                  accum=accum, micro=micro, dtype=prof.param_dtype,
                  use_kernels=use_kernels,
                  form="one-device" if mesh is None else "mesh"))


def _stacked_specs(pspec, c_axes):
    """Each leaf's spec with the clients dim in front."""
    if isinstance(pspec, rules.PartitionSpec):
        return rules.P(c_axes, *pspec)
    if isinstance(pspec, dict):
        return {k: _stacked_specs(v, c_axes) for k, v in pspec.items()}
    return tuple(_stacked_specs(v, c_axes) for v in pspec)


def _check_one_client_a_rank(mesh, n_clients: int) -> None:
    shape = rules.mesh_shape(mesh)
    if shape.get("model", 1) != 1:
        raise NotImplementedError(
            f"mesh {shape}: the port's train step holds one whole client a "
            f"rank (no tensor parallelism over 'model')")
    if dist.get_world_size() != n_clients:
        raise ValueError(f"mesh {shape}: {n_clients} clients on "
                         f"{dist.get_world_size()} ranks; the train step "
                         f"takes one client a rank")


# ==========================================================================
# Serving steps (prefill / decode)
# ==========================================================================

def _serve_param_shardings(prof, mesh, base_params):
    if mesh is None:
        return None
    fsdp = "data" if prof.client_axis == "pod" else None
    pspec = rules.tree_param_specs(base_params, mesh, tp_axes="model",
                                   fsdp_axes=fsdp)
    return rules.tree_shardings(pspec, mesh)


def _batch_axes(mesh, batch: int, fallback):
    if mesh is None:
        return None
    names = rules.mesh_shape(mesh)
    axes = ("pod", "data") if "pod" in names else "data"
    return axes if batch % rules.axis_size(mesh, axes) == 0 else fallback


def cache_spec_tree(cache_structs, batch_axes, mesh):
    """Cache placement specs: the batch dim over ``batch_axes``; the
    attention cache's sequence dim over "model" where it divides.  Caches
    under "layers" are stacked with a leading cycles dim (those under
    "rem_layers" are not), told from the path, never from ndim."""
    msize = rules.mesh_shape(mesh)["model"]

    def walk(tree, keys):
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
        # ssd "h" (B,H,P,N) / rglru "h" (B,W) / "conv" (B,K-1,C): the
        # batch dim only
        return rules.P(*((None,) * lead), batch_axes)

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

    def prefill_step(params, batch):
        return M.prefill_last(cfg, params, batch, S,
                              dispatch=prof.moe_dispatch,
                              quantized_cache=prof.kv_int8)

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

    def decode_step(params, caches, token, pos, enc_out=None):
        logits, caches = M.decode_step(cfg, params, caches, token, pos,
                                       enc_out=enc_out,
                                       dispatch=prof.moe_dispatch)
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
