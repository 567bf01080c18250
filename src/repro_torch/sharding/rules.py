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

One block is cut part by part (:class:`Cut`), where the reference cuts
contiguous blocks of columns: a Mamba-2 SSD layer (the leaves under an
``"ssd"`` key, told by the path, never by a leaf's name: RG-LRU's
``conv_w``/``conv_b`` keep the table's layout).  Its ``in_proj`` columns
are z | x | B C | dt, so a rank holds its heads' z, x and dt columns and
all of B and C; ``conv_w``/``conv_b`` its x channels and all of B and C;
``A_log``, ``D``, ``dt_bias`` its heads and ``norm_scale`` its d_inner
channels; ``out_proj`` its heads' rows, the table's own cut.  Where the
heads do not divide over "model" the whole layer stays whole.
:func:`local_shard` and :func:`gather_full` cut and join by the cuts,
and the DTensor placements, which cannot state such a cut, carry them
beside (:class:`Placements`).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

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


@dataclass(frozen=True)
class Cut:
    """A dim split over its spec's mesh axes part by part: ``parts`` are
    the dim's (length, split) runs in order; a rank holds its block of
    each split run and the whole of each other run, in that order.
    ``dim`` counts from the end, so that stacking dims in front (the
    cycles, the clients) leave it as it is."""
    dim: int
    parts: Tuple[Tuple[int, bool], ...]

    def size(self, n: int) -> int:
        """A rank's length of the dim over ``n`` blocks."""
        return sum(length // n if split else length
                   for length, split in self.parts)

    def runs(self, n: int, index: int):
        """The ``(start, length)`` runs block ``index`` of ``n`` holds."""
        out, at = [], 0
        for length, split in self.parts:
            out.append((at + index * (length // n), length // n) if split
                       else (at, length))
            at += length
        return out


class PartitionSpec(tuple):
    """One entry per tensor dim: None (replicated), a mesh axis name, or a
    tuple of names (the dim split over their product).  ``cuts`` say how
    a dim is split where it is not one contiguous block a rank
    (:class:`Cut`); equality is the tuple's, cuts aside."""

    def __new__(cls, *entries, cuts=()):
        spec = super().__new__(cls, entries)
        spec.cuts = tuple(cuts)
        return spec

    def lead(self, *entries) -> "PartitionSpec":
        """This spec with ``entries`` for new leading dims (its cuts count
        from the end: they stay)."""
        return PartitionSpec(*entries, *self, cuts=self.cuts)

    def __repr__(self) -> str:
        cuts = f", cuts={self.cuts}" if self.cuts else ""
        return f"P{tuple.__repr__(self)[:-1]}{cuts})"


P = PartitionSpec


class Placements(tuple):
    """A leaf's DTensor placements, one per mesh dim, and its spec's
    cuts (a ``Shard`` says which dim an axis splits, not how)."""
    cuts: Tuple[Cut, ...] = ()


def ssd_channel_cuts(d_inner: int, bc: int) -> Tuple[Cut, ...]:
    """The cut of an SSD's conv channels (x | B C, the last dim of
    ``conv_w``, ``conv_b`` and the conv cache): the rank's x channels,
    all ``bc`` of B and C."""
    return (Cut(-1, ((d_inner, True), (bc, False))),)


def _ssd_specs(tree, specs: dict, mesh, tp_axes) -> dict:
    """An SSD layer's specs (``specs``: the table's, leaf by leaf), cut
    part by part over ``tp_axes`` where its heads divide, every
    ``tp_axes`` entry dropped where they do not (the layer then whole)."""
    nh, di = tree["A_log"].shape[-1], tree["norm_scale"].shape[-1]
    bc = tree["conv_w"].shape[-1] - di
    m = axis_size(mesh, tp_axes)
    split = m > 1 and nh % m == 0
    heads, chans = ((nh, True),), ((di, True),)
    conv = ssd_channel_cuts(di, bc)[0].parts
    parts = {"in_proj": chans * 2 + ((bc, False),) + heads,
             "conv_w": conv, "conv_b": conv,
             "A_log": heads, "D": heads, "dt_bias": heads,
             "norm_scale": chans}
    out = {}
    for k, spec in specs.items():
        entries = [None if e == tp_axes else e for e in spec]
        if not split:
            while entries and entries[-1] is None:
                entries.pop()
            out[k] = P(*entries)
        elif k in parts:            # one run is a plain block: no cut
            entries += [None] * (len(tree[k].shape) - len(entries))
            entries[-1] = tp_axes
            out[k] = P(*entries, cuts=(Cut(-1, parts[k]),)
                       if len(parts[k]) > 1 else ())
        else:                               # out_proj: its heads' rows
            out[k] = spec
    return out


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
            out = {k: walk(v, keys + (str(k),)) for k, v in tree.items()}
            if keys and keys[-1] == "ssd":
                out = _ssd_specs(tree, out, mesh, tp_axes)
            return out
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
    ``Shard(d)`` where tensor dim ``d`` names it, else ``Replicate()``;
    a spec with cuts gives :class:`Placements` that carry them."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for axis in mesh_shape(mesh):
        dims = [d for d, e in enumerate(spec)
                if e == axis or (isinstance(e, tuple) and axis in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    if not getattr(spec, "cuts", ()):
        return tuple(out)
    out = Placements(out)
    out.cuts = spec.cuts
    return out


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
        cuts = _cuts_by_dim(spec, x.dim())
        for d, parts, index in _splits(spec, mesh, coords):
            lengths = ([n for n, split in cuts[d].parts if split]
                       if d in cuts else [x.shape[d]])
            if any(n % parts for n in lengths):
                raise ValueError(f"dim {d} of a {tuple(x.shape)} leaf does "
                                 f"not split into {parts} blocks ({spec})")
            if d in cuts:
                x = torch.cat([x.narrow(d, a, n) for a, n in
                               cuts[d].runs(parts, index)], d)
            else:
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
        cuts = _cuts_by_dim(spec, x.dim())
        for d, entry in enumerate(spec):
            if entry is None:
                continue
            axes = (entry,) if isinstance(entry, str) else tuple(entry)
            for a in reversed(axes):
                x = parallel.all_gather(x, d, mesh.get_group(a), shape[a],
                                        coords[a], a)
            if d in cuts:       # the blocks, rank after rank: part by part
                n = math.prod(shape[a] for a in axes)
                blocks, pieces, at = x.chunk(n, d), [], 0
                for length, split in cuts[d].parts:
                    k = length // n if split else length
                    pieces += [b.narrow(d, at, k)
                               for b in (blocks if split else blocks[:1])]
                    at += k
                x = torch.cat(pieces, d)
        return x

    return _walk2(one, tree, specs)


def _cuts_by_dim(spec, ndim: int) -> Dict[int, Cut]:
    return {c.dim % ndim: c for c in getattr(spec, "cuts", ())}
