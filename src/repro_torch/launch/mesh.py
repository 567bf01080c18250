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

import torch
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


def make_mesh(shape, axes=("data", "model"), device_type: str = "cuda"):
    """A mesh of any shape over the whole process group (the launchers'
    ``--mesh DxM``)."""
    return _make_mesh(tuple(shape), tuple(axes), device_type)


def parse_mesh(text: str) -> Tuple[int, int]:
    """``"DxM"`` (``--mesh 2x2``) -> (D, M)."""
    try:
        d, m = (int(v) for v in text.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh {text!r}: want DxM, e.g. 1x2 or 2x2")
    if d < 1 or m < 1:
        raise ValueError(f"--mesh {text!r}: sizes must be >= 1")
    return d, m


def _rank_main(fn, rank: int, world: int, port: int, device_type: str,
               args: tuple) -> None:
    import datetime
    if device_type == "cuda":
        # one card a rank where there are enough of them (nccl); ranks
        # that share a card run gloo over its CUDA tensors
        backend = "nccl" if torch.cuda.device_count() >= world else "gloo"
        torch.cuda.set_device(rank % torch.cuda.device_count())
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=1800))
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world: int, args: tuple = (), *,
                device_type: str = "cuda", timeout_s: float = 3600.0) -> None:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes that
    form one process group over a localhost TCP store (``nccl`` when every
    rank has a card of its own, else ``gloo``; ``gloo`` on the CPU);
    ``fn`` builds its mesh (:func:`make_mesh`).  Raises if a rank fails;
    every rank is stopped on the way out.  Under ``torchrun`` call ``fn``
    after :func:`init_process_group` instead."""
    import multiprocessing
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, port, device_type, args))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout_s)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(30)
    codes = [p.exitcode for p in procs]
    if codes != [0] * world:
        raise RuntimeError(f"mesh ranks exited {codes}")


def local_blocks(make, specs, mesh):
    """(this rank's blocks of the full tree ``make()`` draws, the full
    tree's element count).  The ranks of the process group draw it one
    after another, each cutting its blocks (`rules.local_shard`) a leaf
    at a time and dropping each full leaf as it goes, so that one full
    copy exists at a time on a card the ranks share."""
    import gc
    from repro_torch.sharding import rules
    from repro_torch.tree import tree_leaves, tree_unflatten
    local, count = None, 0
    for r in range(dist.get_world_size()):
        if r == dist.get_rank():
            like = make()
            leaves = tree_leaves(like)
            count = sum(x.numel() for x in leaves)
            specs_ = rules.spec_leaves_like(like, specs)
            cuda = any(x.is_cuda for x in leaves)
            like = tree_unflatten(like, [None] * len(leaves))
            out = []
            for i, spec in enumerate(specs_):
                out.append(rules.local_shard(leaves[i], spec, mesh))
                leaves[i] = None
            local = tree_unflatten(like, out)
            del leaves
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
        dist.barrier()
    return local, count


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


def _axis_group(mesh, axis: str):
    """(process group, this rank's coordinate) of one axis of a
    ``DeviceMesh`` built by :func:`_make_mesh`."""
    if axis not in mesh_axes(mesh):
        raise ValueError(f"mesh {mesh_shape(mesh)} has no {axis!r} axis")
    return mesh.get_group(axis), mesh.get_local_rank(axis)


def model_group(mesh):
    """The "model" axis's process group and this rank's coordinate on it:
    the ranks that hold the tensor-parallel blocks of one replica."""
    return _axis_group(mesh, "model")


def data_group(mesh):
    """The "data" axis's process group and this rank's coordinate: the
    ranks a batch is split over, and an FSDP leaf."""
    return _axis_group(mesh, "data")


def pod_group(mesh):
    """The "pod" axis's process group and this rank's coordinate."""
    return _axis_group(mesh, "pod")


def rank_grid(mesh) -> torch.Tensor:
    """The global rank at each mesh coordinate: a ``DeviceMesh``'s own
    table, or the row-major layout ``init_device_mesh`` gives a mesh
    known by its shape alone."""
    table = getattr(mesh, "mesh", None)
    if isinstance(table, torch.Tensor):
        return table.to(torch.int64)
    sizes = tuple(mesh_shape(mesh).values())
    return torch.arange(math.prod(sizes)).reshape(sizes)


def client_rank_table(mesh, client_axes) -> list:
    """``table[c][j]``: the global rank holding within-client block ``j``
    of client ``c``, clients over ``client_axes`` (None: one client), the
    within-client coordinates (the other axes: "model", and "data" of a
    pod-client layout) in row-major order.  Block ``j`` of every client
    holds the same shard of the parameters."""
    names = mesh_axes(mesh)
    axes = tuple(client_axes or ())
    grid = rank_grid(mesh)
    lead = [names.index(a) for a in axes]
    rest = [i for i in range(len(names)) if i not in lead]
    grid = grid.permute(lead + rest)
    n = math.prod(grid.shape[:len(lead)]) if lead else 1
    return grid.reshape(n, -1).tolist()


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
