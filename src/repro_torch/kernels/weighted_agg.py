"""Launcher for the CUDA ``weighted_agg_multi`` kernel (``csrc/weighted_agg.cu``).

Counterpart of ``repro/kernels/weighted_agg.py::weighted_agg_multi``:
stack (C, P) f32 or bf16, weights (C, K) f32 -> (K, P) in the stack's
dtype, accumulated in f32, one pass over the stack for all K.
:func:`launch_grouped` takes every leaf of a tree at once (one launch for
a FedHC stage-1); :func:`launch` is its one-leaf case, except that K = 1
with small C (``weighted_agg``, the counterpart of
``repro/kernels/weighted_agg.py::weighted_agg``) takes the streaming
small-C kernel of the same source.  The launcher checks its inputs, plans
the launch (:func:`plan_grouped`, pure Python), allocates the outputs and
launches on the current stream; `kernels/ops.py` is the public,
dispatching wrapper.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import math
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from repro_torch.kernels import build

KMAX_BUCKETS = (4, 8, 16)  # clusters a pass (accumulators a lane column);
#                            K > 16 takes passes of the last
WARPS = 8                 # warps of a block; warp w takes rows w, w + 8, ...
MAX_LEAVES = 64           # entries of the kernel's descriptor table: a tree
#                           of more leaves takes one launch a group of 64
SMALL_C_MAX = 32          # K = 1 at C <= this streams (wagg_small_c_kernel)
SMALL_C_ROWS = 8          # C <= this: a thread owns all rows of its columns
#                           (wagg_grouped_rows_kernel; tiles THREADS wide)
THREADS = WARPS * 32
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # codes of the C interface
_SIZES = {torch.float32: 4, torch.bfloat16: 2}


class GroupedPlan(NamedTuple):
    """The launches over every leaf: one block for each column tile
    (``lanes`` x ``vec`` columns) of each leaf and each pass of ``kmax``
    clusters, all C rows: above ``SMALL_C_ROWS`` a tile is 32 lanes and
    the block's 8 warps share the rows (warp w takes rows w, w + 8, ...);
    at C <= ``SMALL_C_ROWS`` it is ``THREADS`` lanes and each thread sums
    all C rows of its columns.  One launch for every ``MAX_LEAVES``
    leaves."""
    order: Tuple[int, ...]    # leaves in work order (the narrowest first)
    vec: Tuple[int, ...]      # per leaf, in leaf order: elements a lane
    #                           loads from a row (16 bytes, or 1)
    tiles: Tuple[int, ...]    # per leaf: column tiles
    first: Tuple[int, ...]    # per leaf: its first tile in its launch's grid
    blocks: int               # blocks of all launches: tiles x passes
    kmax: int                 # clusters a pass (accumulators a lane column)
    passes: int               # ceil(K / kmax)
    groups: Tuple[Tuple[int, ...], ...]   # leaves of each launch, in work
    #                                       order
    lanes: int                # lanes of a column tile (THREADS at small C)

    @property
    def launches(self) -> int:
        return len(self.groups)


class SmallC(NamedTuple):
    vec: int              # bytes a thread loads from a row at once: 16 or
    #                       one element


def plan_grouped(ps: Sequence[int], c: int, k: int, dtype: torch.dtype,
                 aligned: Sequence[bool]) -> GroupedPlan:
    """Launch shape for leaves of ``ps`` columns over ``c`` rows and ``k``
    clusters.  K <= 16 takes one pass of the smallest of 4, 8 or 16
    accumulators that holds it; a larger K takes passes of 16 clusters.  A
    leaf whose rows are 16-byte aligned (``aligned``) loads 16 bytes a
    lane.  The rows are not split over blocks: LeNet's leaves already make
    355 tiles, 2.7 blocks an SM of an H100, and the card measured every
    split slower or no faster (``csrc/weighted_agg.cu``, PERF.md).  At
    C <= ``SMALL_C_ROWS`` a tile is ``THREADS`` lanes wide (a thread a
    lane, all rows).  Leaves go into launches of at most ``MAX_LEAVES``
    (the kernel's table), in work order."""
    if not ps or len(ps) != len(aligned):
        raise ValueError(f"weighted_agg_multi: {len(ps)} leaves and "
                         f"{len(aligned)} alignment flags")
    if k < 1:
        raise ValueError(f"weighted_agg_multi: K={k} clusters")
    if dtype not in _DTYPES:
        raise TypeError(f"weighted_agg_multi: stack dtype {dtype} not in "
                        f"{tuple(_DTYPES)}")
    if c < 1 or min(ps) < 1:
        raise ValueError(f"weighted_agg_multi: empty stack (C={c}, P={ps})")
    kmax = next((b for b in KMAX_BUCKETS if k <= b), KMAX_BUCKETS[-1])
    passes = -(-k // kmax)
    wide = 16 // _SIZES[dtype]
    vec = tuple(wide if a else 1 for a in aligned)
    lanes = THREADS if c <= SMALL_C_ROWS else 32
    tiles = tuple(-(-p // (lanes * v)) for p, v in zip(ps, vec))
    order = tuple(sorted(range(len(ps)), key=lambda i: (ps[i], i)))
    groups = tuple(order[i:i + MAX_LEAVES]
                   for i in range(0, len(order), MAX_LEAVES))
    first = [0] * len(ps)
    for group in groups:
        grid = 0
        for i in group:
            first[i] = grid
            grid += tiles[i]
        if grid * passes >= 2**31:
            raise ValueError(f"weighted_agg_multi: {grid * passes} blocks do "
                             f"not fit a grid")
    return GroupedPlan(order, vec, tiles, tuple(first),
                       sum(tiles) * passes, kmax, passes, groups, lanes)


def plan(c: int, p: int, *, vec4: bool, k: Optional[int] = None,
         small_c_max: int = SMALL_C_MAX, dtype: torch.dtype = torch.float32
         ) -> Union[GroupedPlan, SmallC]:
    """One leaf.  K = 1 at C <= ``small_c_max`` (at most ``SMALL_C_MAX``):
    the streaming small-C kernel; otherwise the grouped kernel's plan for
    the one leaf.  ``vec4`` says the rows may be read 16 bytes at a time."""
    if k == 1 and c <= min(small_c_max, SMALL_C_MAX):
        return SmallC(16 if vec4 else 1)
    return plan_grouped([p], c, k or 1, dtype, [vec4])


@functools.lru_cache(maxsize=None)
def _fn_grouped():
    fn = build.load("weighted_agg").wagg_grouped
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 5 + [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _fn_small_c():
    fn = build.load("weighted_agg").wagg_small_c
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(stack: torch.Tensor, weights: torch.Tensor) -> None:
    """A (C, ...) stack and (C, K) weights the kernel takes."""
    if stack.device.type != "cuda" or weights.device != stack.device:
        raise ValueError(f"weighted_agg_multi: stack on {stack.device} and "
                         f"weights on {weights.device}; both must be on one "
                         f"CUDA device")
    if stack.dtype not in _DTYPES:
        raise TypeError(f"weighted_agg_multi: stack dtype {stack.dtype} not "
                        f"in {tuple(_DTYPES)}")
    if weights.dtype != torch.float32:
        raise TypeError(f"weighted_agg_multi: weights must be float32, got "
                        f"{weights.dtype}")
    if (weights.dim() != 2 or stack.dim() < 1 or stack.numel() == 0
            or stack.shape[0] != weights.shape[0]):
        raise ValueError(f"weighted_agg_multi: stack {tuple(stack.shape)} and "
                         f"weights {tuple(weights.shape)} do not agree (want "
                         f"(C, ...) and (C, K))")
    if weights.shape[1] < 1:
        raise ValueError("weighted_agg_multi: K=0 clusters")
    if stack.shape[0] >= 2**31:
        raise ValueError(f"weighted_agg_multi: C={stack.shape[0]} does not "
                         f"fit an int32")
    if not (stack.is_contiguous() and weights.is_contiguous()):
        raise ValueError("weighted_agg_multi: stack and weights must be "
                         "contiguous")


def _aligned(x: torch.Tensor) -> bool:
    """Rows of ``x`` (C, ...) start on 16-byte boundaries."""
    return (x.numel() // x.shape[0] * x.element_size()) % 16 == 0 \
        and x.data_ptr() % 16 == 0


def _on(dev: torch.device):
    """Make the tensors' device the current one for the launch."""
    if dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


@functools.lru_cache(maxsize=256)
def _planned(shapes: Tuple[torch.Size, ...], k: int, dtype: torch.dtype,
             based: Tuple[bool, ...]):
    """For leaves of ``shapes`` (C, ...) whose data start on a 16-byte
    boundary where ``based`` says so: the plan, the buffer's length, each
    leaf's output view (shape, strides, offset) and, for each launch, its
    per-leaf arrays in work order for the C interface and its tiles."""
    c = shapes[0][0]
    ps = tuple(math.prod(s[1:]) for s in shapes)
    aligned = [b and (p * _SIZES[dtype]) % 16 == 0 for b, p in zip(based, ps)]
    pl = plan_grouped(ps, c, k, dtype, aligned)
    views, off = [], 0
    for s, p in zip(shapes, ps):
        shape = (k,) + tuple(s[1:])
        strides = [1] * len(shape)
        for d in range(len(shape) - 2, -1, -1):
            strides[d] = strides[d + 1] * shape[d + 1]
        views.append((shape, tuple(strides), off))
        off += k * p
    arrays = []
    for group in pl.groups:
        n = len(group)
        arrays.append(((ctypes.c_longlong * n)(*[ps[i] for i in group]),
                       (ctypes.c_int * n)(*[pl.first[i] for i in group]),
                       (ctypes.c_int * n)(*[pl.vec[i] for i in group]),
                       sum(pl.tiles[i] for i in group)))
    return pl, off, tuple(views), tuple(arrays)


def launch_grouped(leaves: Sequence[torch.Tensor],
                   weights: torch.Tensor) -> List[torch.Tensor]:
    """Every (C, ...) leaf in ``ceil(len(leaves) / MAX_LEAVES)`` launches
    (one for a tree of up to 64 leaves): returns the (K, ...) outputs,
    contiguous views of one buffer of K * sum(P_i) elements, leaf-major
    (P_i a leaf's elements per client).  Raises on what the kernel does not
    take and on a refused launch."""
    if not leaves:
        raise ValueError("weighted_agg_multi: no leaves")
    x0 = leaves[0]
    _check(x0, weights)
    dt, dev, c = x0.dtype, x0.device, x0.shape[0]
    for x in leaves[1:]:          # the full check only where one fails
        if (x.device != dev or x.dtype != dt or x.dim() < 1
                or x.shape[0] != c or x.numel() == 0
                or not x.is_contiguous()):
            _check(x, weights)
            raise TypeError(f"weighted_agg_multi: leaves of several dtypes "
                            f"({dt} and {x.dtype})")
    k = weights.shape[1]
    pl, total, views, arrays = _planned(
        tuple(x.shape for x in leaves), k, dt,
        tuple(x.data_ptr() % 16 == 0 for x in leaves))
    out = torch.empty((total,), dtype=dt, device=dev)
    base, size = out.data_ptr(), out.element_size()
    with _on(dev):
        stream = torch.cuda.current_stream().cuda_stream
        for group, (ps_arr, first_arr, vec_arr, tiles) in zip(pl.groups,
                                                              arrays):
            n = len(group)
            err = _fn_grouped()(
                _DTYPES[dt], n,
                (ctypes.c_void_p * n)(*[leaves[i].data_ptr() for i in group]),
                (ctypes.c_void_p * n)(*[base + size * views[i][2]
                                        for i in group]),
                ps_arr, first_arr, vec_arr, tiles, weights.data_ptr(), c, k,
                pl.kmax, stream)
            if err:
                shapes = [tuple(leaves[i].shape) for i in group]
                raise RuntimeError(
                    f"weighted_agg_multi launch failed: CUDA error {err} "
                    f"(leaves {shapes}, K={k} in {pl.passes} passes of "
                    f"{pl.kmax}, {dt}, {tiles} tiles)")
    return [torch.as_strided(out, *v) for v in views]


def launches(n_leaves: int) -> int:
    """Launches :func:`launch_grouped` makes for a tree of ``n_leaves``."""
    return -(-n_leaves // MAX_LEAVES)


def launch(stack: torch.Tensor, weights: torch.Tensor, *,
           small_c_max: int = SMALL_C_MAX) -> torch.Tensor:
    """Launch on one (C, P) stack of CUDA tensors; raises on a refused
    launch.  ``small_c_max`` moves the small-C threshold (chip_smoke.py
    times both kernels across it)."""
    _check(stack, weights)
    if stack.dim() != 2:
        raise ValueError(f"weighted_agg_multi: want stack (C, P), got "
                         f"{tuple(stack.shape)}")
    c, p = stack.shape
    k = weights.shape[1]
    pl = plan(c, p, vec4=_aligned(stack), k=k, small_c_max=small_c_max,
              dtype=stack.dtype)
    if isinstance(pl, GroupedPlan):
        return launch_grouped([stack], weights)[0]
    out = torch.empty((k, p), dtype=stack.dtype, device=stack.device)
    with _on(stack.device):
        err = _fn_small_c()(_DTYPES[stack.dtype], stack.data_ptr(),
                            weights.data_ptr(), out.data_ptr(), c, p, pl.vec,
                            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"weighted_agg launch failed: CUDA error {err} "
                           f"(C={c}, P={p}, {stack.dtype}, {pl})")
    return out
