"""Launcher for the CUDA ``weighted_agg_multi`` kernel (``csrc/weighted_agg.cu``).

Counterpart of ``repro/kernels/weighted_agg.py::weighted_agg_multi``:
stack (C, P) f32 or bf16, weights (C, K) f32 -> (K, P) in the stack's
dtype, accumulated in f32, one pass over the stack for all K.  K = 1 with
small C (``weighted_agg``, the counterpart of
``repro/kernels/weighted_agg.py::weighted_agg``) takes the streaming
small-C kernel of the same source.  The launcher checks its inputs, plans
the launch (:func:`plan`), allocates the output and any scratch, and
launches on the current stream; `kernels/ops.py` is the public,
dispatching wrapper.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Union

import torch

from repro_torch.kernels import build

K_MAX = 16
MIN_ROWS_PER_SPLIT = 64   # rows a block walks at least: 8 for each of the
#                           8 warps of a block (csrc/weighted_agg.cu)
_SYMBOLS = {torch.float32: "wagg_multi_f32", torch.bfloat16: "wagg_multi_bf16"}


SMALL_C_MAX = 32          # K = 1 at C <= this streams (wagg_small_c_kernel)


class Plan(NamedTuple):
    vec: int              # columns per lane: 4 (one float4 load) or 1
    splits: int           # blocks along C; > 1 adds a summing pass


class SmallC(NamedTuple):
    vec: int              # bytes a thread loads from a row at once: 16 or
    #                       one element


def plan(c: int, p: int, *, vec4: bool, num_sms: int, k: Optional[int] = None,
         small_c_max: int = SMALL_C_MAX) -> Union[Plan, SmallC]:
    """Launch shape.  K = 1 at C <= ``small_c_max``: the streaming small-C
    kernel, 16-byte loads where ``vec4`` allows them.  Otherwise the
    weighted_agg_multi kernel: float4 lanes where allowed, and enough
    splits of the C rows that the grid holds about two blocks per SM (a
    block walks at least ``MIN_ROWS_PER_SPLIT`` rows, so small C stays one
    split)."""
    if k == 1 and c <= small_c_max:
        return SmallC(16 if vec4 else 1)
    vec = 4 if vec4 else 1
    tiles = -(-p // (32 * vec))
    splits = max(1, min(c // MIN_ROWS_PER_SPLIT, (2 * num_sms) // tiles))
    rows = -(-c // splits)
    return Plan(vec, -(-c // rows))


@functools.lru_cache(maxsize=None)
def _fn(symbol: str):
    fn = getattr(build.load("weighted_agg"), symbol)
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong] \
        + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _fn_small_c():
    fn = build.load("weighted_agg").wagg_small_c
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(stack: torch.Tensor, weights: torch.Tensor) -> None:
    if stack.device.type != "cuda" or weights.device != stack.device:
        raise ValueError(f"weighted_agg_multi: stack on {stack.device} and "
                         f"weights on {weights.device}; both must be on one "
                         f"CUDA device")
    if stack.dtype not in _SYMBOLS:
        raise TypeError(f"weighted_agg_multi: stack dtype {stack.dtype} not "
                        f"in {tuple(_SYMBOLS)}")
    if weights.dtype != torch.float32:
        raise TypeError(f"weighted_agg_multi: weights must be float32, got "
                        f"{weights.dtype}")
    if stack.dim() != 2 or weights.dim() != 2:
        raise ValueError(f"weighted_agg_multi: want stack (C, P) and weights "
                         f"(C, K), got {tuple(stack.shape)} and "
                         f"{tuple(weights.shape)}")
    c, p = stack.shape
    if weights.shape[0] != c or c < 1 or p < 1:
        raise ValueError(f"weighted_agg_multi: stack {tuple(stack.shape)} and "
                         f"weights {tuple(weights.shape)} do not agree")
    if not 1 <= weights.shape[1] <= K_MAX:
        raise ValueError(f"weighted_agg_multi: K={weights.shape[1]} outside "
                         f"[1, {K_MAX}] (K accumulators live in registers)")
    if c >= 2**31:
        raise ValueError(f"weighted_agg_multi: C={c} does not fit an int32")
    if not (stack.is_contiguous() and weights.is_contiguous()):
        raise ValueError("weighted_agg_multi: stack and weights must be "
                         "contiguous")


def launch(stack: torch.Tensor, weights: torch.Tensor, *,
           small_c_max: int = SMALL_C_MAX) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; raises on a refused launch.
    ``small_c_max`` moves the small-C threshold (chip_smoke.py times both
    kernels across it)."""
    _check(stack, weights)
    c, p = stack.shape
    k = weights.shape[1]
    dev = stack.device
    aligned = (p * stack.element_size()) % 16 == 0 \
        and stack.data_ptr() % 16 == 0
    small_c_max = min(small_c_max, SMALL_C_MAX)
    # 16-byte loads: float4 lanes of the multi kernel (f32 only), or the
    # small-C kernel's 16-byte rows (f32 or bf16)
    wide = stack.dtype == torch.float32 or (k == 1 and c <= small_c_max)
    pl = plan(c, p, k=k, small_c_max=small_c_max, vec4=aligned and wide,
              num_sms=_num_sms(dev.index if dev.index is not None
                               else torch.cuda.current_device()))
    out = torch.empty((k, p), dtype=stack.dtype, device=dev)
    part = (torch.empty((pl.splits, k, p), dtype=torch.float32, device=dev)
            if isinstance(pl, Plan) and pl.splits > 1 else None)
    with torch.cuda.device(dev):          # launch on the tensors' device
        stream = torch.cuda.current_stream().cuda_stream
        if isinstance(pl, SmallC):
            err = _fn_small_c()(int(stack.dtype == torch.bfloat16),
                                stack.data_ptr(), weights.data_ptr(),
                                out.data_ptr(), c, p, pl.vec, stream)
        else:
            err = _fn(_SYMBOLS[stack.dtype])(
                stack.data_ptr(), weights.data_ptr(), out.data_ptr(),
                part.data_ptr() if part is not None else None, c, p, k,
                pl.vec, pl.splits, stream)
    if err:
        raise RuntimeError(f"weighted_agg_multi launch failed: CUDA error "
                           f"{err} (C={c}, P={p}, K={k}, {stack.dtype}, "
                           f"{pl})")
    return out
