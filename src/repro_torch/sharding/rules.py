"""Logical sharding rules: param-name pattern -> partition spec, with
divisibility-checked fallbacks.

Counterpart of ``repro/sharding/rules.py``: the same role table
(``_BASE_RULES``), the same placements and the same fallback to
replicated.  A spec is a :class:`PartitionSpec`, a tuple with one entry
per tensor dim (None, a mesh axis name, or a tuple of names) and its
trailing Nones trimmed, as the reference's ``PartitionSpec``;
:func:`tree_shardings` turns specs into DTensor placements
(``Shard(d)`` / ``Replicate()``, one per mesh dim) on a ``DeviceMesh``.

Roles per tensor dim (resolved to mesh axes by a placement):
    tp    - tensor-parallel dim (d_ff, q/kv projection output, vocab)
    fsdp  - fully-sharded dim (weight input dim; only in pod-client or
            serve-big placements where the data axis is free for FSDP)
    none  - replicated

Placements:
    client-data : one FL client per data-axis index.  Params get a leading
                  clients dim sharded over ("pod","data"); within a client
                  only `tp` shards (over "model").
    client-pod  : one FL client per pod.  Clients dim over "pod"; inside a
                  client `fsdp`->"data", `tp`->"model".
    serve       : no clients dim.  `tp`->"model"; `fsdp`->"data" only when
                  ``fsdp_params=True``.

Any dim whose size does not divide the product of its mesh-axis sizes
falls back to replicated.  The rules read only a mesh's axis names and
sizes (:func:`mesh_shape`): a ``DeviceMesh``, or any object with a
``shape`` dict and ``axis_names``, as the tests' ``FakeMesh``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

# param leaf name -> per-dim roles (for the base, unstacked shape)
_BASE_RULES = {
    # embeddings
    "embedding": ("tp", "fsdp"),
    "unembed": ("fsdp", "tp"),
    "enc_pos": (None, None),
    "proj": ("fsdp", "tp"),
    # attention
    "wq": ("fsdp", "tp"),
    "wk": ("fsdp", "tp"),
    "wv": ("fsdp", "tp"),
    "wo": ("tp", "fsdp"),
    "bq": ("tp",),
    "bk": ("tp",),
    "bv": ("tp",),
    # mlp
    "w_gate": ("fsdp", "tp"),
    "w_up": ("fsdp", "tp"),
    "w_down": ("tp", "fsdp"),
    # moe (leading experts dim replicated; per-expert TP)
    "router": ("fsdp", None),
    # ssd
    "in_proj": ("fsdp", "tp"),
    "conv_w": (None, "tp"),
    "conv_b": ("tp",),
    "A_log": (None,),
    "D": (None,),
    "dt_bias": (None,),
    "norm_scale": (None,),
    "out_proj": ("tp", "fsdp"),
    # rglru
    "w_x": ("fsdp", "tp"),
    "lru_wa": ("fsdp", "tp"),
    "lru_wx": ("fsdp", "tp"),
    "lru_ba": ("tp",),
    "lru_bx": ("tp",),
    "lru_lambda": ("tp",),
    "w_out": ("tp", "fsdp"),
    # norms
    "scale": (None,),
}
# MoE expert weights share names with the dense MLP but have a leading
# experts dim; handled by the ndim mismatch logic below.


class PartitionSpec(tuple):
    """One entry per tensor dim: None (replicated), a mesh axis name, or a
    tuple of names (the dim split over their product)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (``mesh_dim_names`` and
    its shape tuple) or of a mesh with a ``shape`` dict."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def axis_size(mesh, axes) -> int:
    """Product of the given mesh-axis sizes (1 for None; str or tuple).
    The one source of truth for divisibility checks here and in
    `launch/mesh.validate_client_sharding`."""
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    shape = mesh_shape(mesh)
    return int(math.prod(shape[a] for a in axes))


def _resolve(role: Optional[str], tp_axes, fsdp_axes):
    if role == "tp":
        return tp_axes
    if role == "fsdp":
        return fsdp_axes
    return None


def spec_for_param(path_keys: Tuple[str, ...], shape: Tuple[int, ...],
                   mesh, *, tp_axes="model", fsdp_axes=None,
                   client_axes=None,
                   client_stacked: bool = False) -> PartitionSpec:
    """The partition spec of one param leaf.

    path_keys: tuple of str path components (dict keys / tuple indices as
    str).  client_stacked: the leaf has an extra leading clients dim."""
    roles = _BASE_RULES.get(path_keys[-1])
    if roles is None:
        roles = (None,) * len(shape)

    n_lead = len(shape) - len(roles)
    lead_roles = []
    if client_stacked:
        lead_roles.append("client")
        n_lead -= 1
    # remaining leading dims: scan-cycle stacking and/or experts dim
    lead_roles.extend([None] * n_lead)
    full_roles = tuple(lead_roles) + roles

    entries = []
    for dim, role in zip(shape, full_roles):
        if role == "client":
            axes = client_axes
        else:
            axes = _resolve(role, tp_axes, fsdp_axes)
        if axes is not None and dim % axis_size(mesh, axes) != 0:
            axes = None                      # divisibility fallback
        entries.append(axes)
    while entries and entries[-1] is None:
        entries.pop()
    return PartitionSpec(*entries)


def tree_param_specs(params, mesh, *, tp_axes="model", fsdp_axes=None,
                     client_axes=None, client_stacked: bool = False):
    """Spec tree matching ``params`` (dicts, tuples, lists; leaves are
    anything with a ``shape``: tensors or shape structs)."""

    def walk(tree, keys):
        if isinstance(tree, dict):
            return {k: walk(v, keys + (str(k),)) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            out = [walk(v, keys + (str(i),)) for i, v in enumerate(tree)]
            return tuple(out) if isinstance(tree, tuple) else out
        if tree is None:
            return None
        return spec_for_param(keys, tuple(tree.shape), mesh,
                              tp_axes=tp_axes, fsdp_axes=fsdp_axes,
                              client_axes=client_axes,
                              client_stacked=client_stacked)

    return walk(params, ())


def placements(spec: PartitionSpec, mesh) -> tuple:
    """DTensor placements of one spec on ``mesh``: for each mesh dim,
    ``Shard(d)`` where tensor dim ``d`` names it, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for axis in mesh_shape(mesh):
        dims = [d for d, e in enumerate(spec)
                if e == axis or (isinstance(e, tuple) and axis in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def tree_shardings(specs, mesh):
    """Placement tuples for a spec tree (:func:`placements` per leaf)."""
    def walk(tree):
        if isinstance(tree, PartitionSpec):
            return placements(tree, mesh)
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            out = [walk(v) for v in tree]
            return tuple(out) if isinstance(tree, tuple) else out
        return tree
    return walk(specs)


def spec_leaves(specs) -> list:
    """The specs of a spec tree in leaf order (a spec is a tuple, so the
    tree's own flatten would walk into it)."""
    if isinstance(specs, PartitionSpec):
        return [specs]
    if isinstance(specs, dict):
        return [x for v in specs.values() for x in spec_leaves(v)]
    if isinstance(specs, (tuple, list)):
        return [x for v in specs for x in spec_leaves(v)]
    return []


def spec_leaves_like(tree, specs) -> list:
    """The specs of ``tree``'s leaves in ``tree``'s own leaf order (its
    dicts matched to ``specs`` by key, whatever their order)."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in spec_leaves_like(v, specs[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v, s in zip(tree, specs)
                for x in spec_leaves_like(v, s)]
    return [specs]


def batch_spec(batch_axes) -> PartitionSpec:
    """Spec for (global_batch, ...) data arrays."""
    return PartitionSpec(batch_axes)


def client_spec(mesh, client_axes, num_clients: int) -> PartitionSpec:
    """Spec for a per-client array with a leading (num_clients, ...) dim:
    sharded over ``client_axes`` when the count divides the axis size,
    replicated otherwise (the fallback of :func:`spec_for_param`)."""
    if client_axes is None:
        return PartitionSpec()
    if num_clients % axis_size(mesh, client_axes) != 0:
        return PartitionSpec()
    return PartitionSpec(client_axes)


# --------------------------------------------------------------------------
# Local blocks: a rank's shard of a full tree, and back
# --------------------------------------------------------------------------

def coordinates(mesh) -> Dict[str, int]:
    """This rank's coordinate on each axis of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def _splits(spec: PartitionSpec, mesh, coords: Dict[str, int]):
    """``(dim, parts, index)`` of each sharded dim of ``spec``: a dim over
    a tuple of axes is split over their product, the first axis
    outermost."""
    shape = mesh_shape(mesh)
    out = []
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        parts, index = 1, 0
        for a in axes:
            index = index * shape[a] + coords[a]
            parts *= shape[a]
        out.append((d, parts, index))
    return out


def _walk2(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _walk2(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        out = [_walk2(fn, v, s) for v, s in zip(tree, specs)]
        return tuple(out) if isinstance(tree, tuple) else out
    if tree is None:
        return None
    return fn(tree, specs)


def local_shard(tree, specs, mesh, coords: Optional[Dict[str, int]] = None):
    """This rank's blocks of a full tree (for example
    ``transformer.params_from_numpy`` of the reference's arrays): each
    leaf cut along the dims its spec shards, at the rank's mesh
    coordinates (``coords``, default the ``DeviceMesh``'s own).  The specs
    come from :func:`tree_param_specs`, so a dim the divisibility
    fallback left whole stays whole; a spec that does not divide its dim
    raises."""
    coords = coordinates(mesh) if coords is None else coords

    def one(x, spec):
        for d, parts, index in _splits(spec, mesh, coords):
            if x.shape[d] % parts:
                raise ValueError(f"dim {d} of a {tuple(x.shape)} leaf does "
                                 f"not split into {parts} blocks ({spec})")
            n = x.shape[d] // parts
            x = x.narrow(d, index * n, n)
        return x.clone()

    return _walk2(one, tree, specs)


def gather_full(tree, specs, mesh):
    """The inverse of :func:`local_shard`, on every rank: each leaf
    all-gathered along its sharded dims, over each axis's process group
    (the innermost axis of a tuple first).  For tests and checkpoints."""
    from repro_torch.sharding import parallel
    shape = mesh_shape(mesh)
    coords = coordinates(mesh)

    def one(x, spec):
        for d, entry in enumerate(spec):
            if entry is None:
                continue
            axes = (entry,) if isinstance(entry, str) else tuple(entry)
            for a in reversed(axes):
                x = parallel.all_gather(x, d, mesh.get_group(a), shape[a],
                                        coords[a], a)
        return x

    return _walk2(one, tree, specs)
