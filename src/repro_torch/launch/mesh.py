"""Mesh construction: the production shapes and the FL client mesh.

Counterpart of ``repro/launch/mesh.py`` over ``torch.distributed``.  The
reference lays a client axis over the devices of one program (GSPMD);
here there is one process a rank, each holding only its own rows of the
client stack, and the collectives are explicit
(`core/aggregation_spmd.py`).  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` built over the process group
the caller has already initialized (``torchrun``, or
:func:`init_process_group`): nothing here starts one, so a run that asks
for a mesh without a process group raises instead of running unsharded.

Backends: ``nccl`` for ``cuda`` tensors, ``gloo`` for ``cpu`` ones
(:func:`init_process_group` picks by device).  Two ranks that share one
card cannot use NCCL (it refuses a duplicate GPU); they run ``gloo``
over CUDA tensors, whose ``all_reduce`` and ``broadcast`` stage through
the host, and the client mesh uses no other collective.

The production shapes stay shapes, as in the reference: (data=16,
model=16) for one pod, (pod=2, data=16, model=16) for two.  Functions,
never module-level meshes, so importing this module touches no process
group.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch.distributed as dist

from repro_torch.sharding.rules import axis_size, mesh_shape

PRODUCTION_SHAPE: Tuple[Tuple[int, ...], Tuple[str, ...]] = (
    (16, 16), ("data", "model"))
MULTI_POD_SHAPE: Tuple[Tuple[int, ...], Tuple[str, ...]] = (
    (2, 16, 16), ("pod", "data", "model"))


def init_process_group(device_type: str = "cuda", **kwargs) -> None:
    """``torch.distributed.init_process_group`` with the backend a client
    mesh on ``device_type`` needs (``nccl`` on ``cuda``, ``gloo`` on
    ``cpu``); ``kwargs`` pass through (``init_method``, ``rank``,
    ``world_size``; under ``torchrun`` none is needed)."""
    backend = {"cuda": "nccl", "cpu": "gloo"}[device_type]
    dist.init_process_group(backend=backend, **kwargs)


def _require_process_group() -> None:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "a client mesh needs an initialized torch.distributed process "
            "group: launch with torchrun (torchrun --nproc-per-node W "
            "script.py, the script calling "
            "repro_torch.launch.mesh.init_process_group) or call "
            "torch.distributed.init_process_group before asking for "
            "mesh_devices")


def _make_mesh(shape, axes, device_type: str):
    from torch.distributed.device_mesh import init_device_mesh
    _require_process_group()
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a mesh of shape {tuple(shape)} needs "
                         f"{math.prod(shape)} ranks; the process group has "
                         f"{world}")
    backend = str(dist.get_backend())
    if device_type == "cpu" and "gloo" not in backend:
        raise ValueError(f"a cpu mesh needs the gloo backend, not "
                         f"{backend!r}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape, axes = MULTI_POD_SHAPE if multi_pod else PRODUCTION_SHAPE
    return _make_mesh(shape, axes, device_type)


def make_test_mesh(shape=(2, 2), axes=("data", "model"),
                   device_type: str = "cpu"):
    """Small mesh for tests (needs ``prod(shape)`` ranks)."""
    return _make_mesh(shape, axes, device_type)


def make_client_mesh(num_devices: Optional[int] = None,
                     axis: str = "clients", *, device_type: str = "cuda"):
    """1-D client mesh, one shard of the client stack a rank, over every
    rank of the process group.  ``num_devices`` None or 0 means the whole
    world; any other value must equal the world size (a rank is a device
    here, and a rank outside the mesh would have no rows)."""
    _require_process_group()
    world = dist.get_world_size()
    if num_devices and num_devices != world:
        raise ValueError(
            f"mesh_devices={num_devices} must be 0 (the whole world) or the "
            f"process group's world size {world}: each rank holds one "
            f"shard of the client axis")
    return _make_mesh((world,), (axis,), device_type)


def mesh_axes(mesh) -> tuple:
    return tuple(mesh_shape(mesh))


def client_axis_size(mesh, client_axes) -> int:
    """Total number of shards the client dim is split into
    (`sharding/rules.axis_size`, the one source of the divisibility
    semantics)."""
    return axis_size(mesh, client_axes or None)


def validate_client_sharding(mesh, client_axes, num_clients: int) -> None:
    """Raise unless ``num_clients`` divides evenly over the client mesh
    axes: a ragged shard would hold other rows on other ranks, so an
    explicit error is the only safe behaviour."""
    size = client_axis_size(mesh, client_axes)
    if num_clients % size:
        raise ValueError(
            f"num_clients={num_clients} is not divisible by the client "
            f"mesh axis size {size} (axes {client_axes!r}, mesh "
            f"{mesh_shape(mesh)}): the client stack would be padded and "
            f"mis-sharded. Pick num_clients as a multiple of {size} or "
            f"shrink the client axes.")


def process_local_client_rows(num_clients: int) -> int:
    """How many rows of a (C, ...) client-stacked array this process
    builds in a sharded setup: each of the P ranks holds C/P consecutive
    rows, rank r rows ``[r*C/P, (r+1)*C/P)``.  Without a process group
    there is one process and it holds every row."""
    p = (dist.get_world_size()
         if dist.is_available() and dist.is_initialized() else 1)
    if num_clients % p:
        raise ValueError(
            f"num_clients={num_clients} is not divisible by the "
            f"process count {p}: per-host sharded setup needs each "
            f"process to contribute an equal block of client rows")
    return num_clients // p


def client_axes_for(mesh, client_axis: str,
                    num_clients: Optional[int] = None):
    """Mesh axes over which FL clients are laid out.  Pass ``num_clients``
    to validate divisibility (raises instead of silently mis-sharding)."""
    names = mesh_axes(mesh)
    if client_axis == "pod":
        axes = ("pod",) if "pod" in names else None   # None => 1 client
    else:
        # a client per data index, across pods when present
        axes = tuple(a for a in ("pod", "data") if a in names)
    if num_clients is not None:
        if axes:
            validate_client_sharding(mesh, axes, num_clients)
        elif num_clients != 1:
            raise ValueError(
                f"mesh {mesh_shape(mesh)} has no client axes for "
                f"client_axis={client_axis!r} (it lays out exactly 1 "
                f"client), but num_clients={num_clients} was requested")
    return axes


def num_clients_for(mesh, client_axis: str,
                    num_clients: Optional[int] = None) -> int:
    """Number of clients the mesh lays out (one per client-axis index).
    Pass ``num_clients`` to additionally validate that an externally
    chosen client count divides the axis size."""
    axes = client_axes_for(mesh, client_axis, num_clients)
    if not axes:
        return 1
    return client_axis_size(mesh, axes)
