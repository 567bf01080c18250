"""Tree checkpoints: nested dict/tuple/list trees of tensors saved as one
``.npz`` plus a ``.meta.json`` holding the tree's structure and the step.

Counterpart of ``repro/checkpoint/checkpoint.py``, in its on-disk format:
the same flattened keys ("layers/0/attn/wq"; tuples and lists by index,
``None`` as a ``#none`` key), the same structure JSON and the same raw
views for the dtypes ``.npz`` cannot hold (bf16 as ``uint16``, float8 as
``uint8``, the dtype's name in the meta), so a file either package writes
restores in the other.  The port views such a leaf back with torch's own
dtypes (no ``ml_dtypes``).  The reference's ``restore(path,
shardings=)`` is ``restore(path, mesh=, placements=)`` here: with a
placement tree (`sharding/rules.tree_shardings`), each rank keeps only
its own block of each sharded dim.
"""
from __future__ import annotations

import json
import os
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import device as device_lib

# dtype name -> (the .npz's raw unsigned view, the same-width signed int
# that numpy and torch both hold)
_EXOTIC = {"bfloat16": (np.uint16, np.int16),
           "float8_e4m3fn": (np.uint8, np.int8),
           "float8_e5m2": (np.uint8, np.int8)}


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return np.asarray(leaf).dtype.name


def _to_numpy(leaf) -> np.ndarray:
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    name = _dtype_name(leaf)
    t = leaf.detach().cpu()
    if name in _EXOTIC:                  # npz can't store bf16/f8: raw view
        raw, signed = _EXOTIC[name]
        return t.view(getattr(torch, np.dtype(signed).name)).numpy() \
            .view(raw)
    return t.numpy()


def _flatten(tree, prefix="", out=None):
    out = {} if out is None else out
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], f"{prefix}{k}/", out)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}/", out)
    elif tree is None:
        out[prefix[:-1] + "#none"] = np.zeros((0,))
    else:
        out[prefix[:-1]] = _to_numpy(tree)
    return out


def _structure(tree):
    if isinstance(tree, dict):
        return {"__kind__": "dict",
                "items": {k: _structure(v) for k, v in tree.items()}}
    if isinstance(tree, tuple):
        return {"__kind__": "tuple", "items": [_structure(v) for v in tree]}
    if isinstance(tree, list):
        return {"__kind__": "list", "items": [_structure(v) for v in tree]}
    if tree is None:
        return {"__kind__": "none"}
    return {"__kind__": "leaf", "dtype": _dtype_name(tree)}


def _meta_path(path: str) -> str:
    base = path[:-4] if path.endswith(".npz") else path
    return base + ".meta.json"


def save(path: str, tree: Any, step: Optional[int] = None) -> None:
    flat = _flatten(tree)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    meta = {"structure": _structure(tree), "step": step}
    np.savez(path if path.endswith(".npz") else path + ".npz", **flat)
    with open(_meta_path(path), "w") as f:
        json.dump(meta, f)


def _local_block(t: torch.Tensor, placements, mesh) -> torch.Tensor:
    """This rank's block of ``t`` under DTensor ``placements`` (one per
    mesh dim): each ``Shard(d)`` keeps the rank's equal block of dim d."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            n = mesh.size(i)
            if t.shape[p.dim] % n:
                raise ValueError(f"dim {p.dim} of size {t.shape[p.dim]} "
                                 f"does not split over {n} ranks")
            size = t.shape[p.dim] // n
            t = t.narrow(p.dim, coord[i] * size, size)
    return t.contiguous()


def _leaf(arr: np.ndarray, want: Optional[str], dev) -> torch.Tensor:
    if want in _EXOTIC and arr.dtype.name != want:   # the raw view
        t = torch.from_numpy(arr.view(_EXOTIC[want][1]))
        return t.view(getattr(torch, want)).to(dev)
    return torch.from_numpy(arr).to(dev)


def _rebuild(struct, flat, prefix, placements, mesh, dev):
    kind = struct["__kind__"]
    if kind == "dict":
        return {k: _rebuild(v, flat, f"{prefix}{k}/",
                            None if placements is None else placements.get(k),
                            mesh, dev)
                for k, v in struct["items"].items()}
    if kind in ("tuple", "list"):
        seq = [_rebuild(v, flat, f"{prefix}{i}/",
                        None if placements is None else placements[i],
                        mesh, dev)
               for i, v in enumerate(struct["items"])]
        return tuple(seq) if kind == "tuple" else seq
    if kind == "none":
        return None
    t = _leaf(flat[prefix[:-1]], struct.get("dtype"), dev)
    if placements is not None:
        t = _local_block(t, placements, mesh)
    return t


def restore(path: str, *, mesh=None, placements: Any = None, device=None):
    """Returns ``(tree, step)``, the leaves as tensors on ``device``
    (default ``cuda``).  ``placements``, a tree of DTensor placement
    tuples matching the saved tree (`sharding/rules.tree_shardings`),
    needs the ``mesh`` they refer to; each rank then keeps its own
    blocks."""
    if (mesh is None) != (placements is None):
        raise ValueError("pass mesh and placements together")
    dev = device_lib.resolve(device)
    with np.load(path if path.endswith(".npz") else path + ".npz") as npz:
        flat = {k: npz[k] for k in npz.files}
    with open(_meta_path(path)) as f:
        meta = json.load(f)
    tree = _rebuild(meta["structure"], flat, "", placements, mesh, dev)
    return tree, meta.get("step")
