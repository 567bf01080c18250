"""Launcher for the CUDA ``kmeans_assign`` kernel (``csrc/kmeans.cu``).

Counterpart of ``repro/kernels/kmeans.py::kmeans_assign``: x (N, D) f32,
centroids (K, D) f32 -> (assignment (N,) int32, min squared distance (N,)
f32).  The launcher checks its inputs, allocates the outputs and launches
on the current stream; `kernels/ops.py` is the public, dispatching wrapper.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import build

SMEM_FLOATS = 48 * 1024 // 4     # static shared-memory budget of a block


def _check(x: torch.Tensor, centroids: torch.Tensor) -> None:
    if x.device.type != "cuda" or centroids.device != x.device:
        raise ValueError(f"kmeans_assign: x on {x.device} and centroids on "
                         f"{centroids.device}; both must be on one CUDA "
                         f"device")
    if x.dtype != torch.float32 or centroids.dtype != torch.float32:
        raise TypeError(f"kmeans_assign: want float32, got {x.dtype} and "
                        f"{centroids.dtype}")
    if x.dim() != 2 or centroids.dim() != 2 or x.shape[1] != centroids.shape[1]:
        raise ValueError(f"kmeans_assign: want x (N, D) and centroids (K, D), "
                         f"got {tuple(x.shape)} and {tuple(centroids.shape)}")
    n, d = x.shape
    k = centroids.shape[0]
    if min(n, d, k) < 1 or n >= 2**31:
        raise ValueError(f"kmeans_assign: empty or oversized input "
                         f"(N={n}, D={d}, K={k})")
    if k * (d + 1) > SMEM_FLOATS:
        raise ValueError(f"kmeans_assign: K*(D+1)={k * (d + 1)} floats of "
                         f"centroids exceed the {SMEM_FLOATS}-float shared "
                         f"memory budget")
    if not (x.is_contiguous() and centroids.is_contiguous()):
        raise ValueError("kmeans_assign: x and centroids must be contiguous")


@functools.lru_cache(maxsize=None)
def _fn():
    fn = build.load("kmeans").kmeans_assign_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch(x: torch.Tensor, centroids: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on CUDA tensors; raises on a refused launch."""
    _check(x, centroids)
    n, d = x.shape
    k = centroids.shape[0]
    assign = torch.empty((n,), dtype=torch.int32, device=x.device)
    dmin = torch.empty((n,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):     # launch on the tensors' device
        err = _fn()(x.data_ptr(), centroids.data_ptr(), assign.data_ptr(),
                    dmin.data_ptr(), n, d, k,
                    torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"kmeans_assign launch failed: CUDA error {err} "
                           f"(N={n}, D={d}, K={k})")
    return assign, dmin
