"""Launcher for the CUDA ``flash_attention`` kernels.

Counterpart of ``repro/kernels/flash_attention.py::flash_attention`` (forward
only): q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D), float32 or bfloat16 ->
(B, Hq, Sq, D) in q's dtype.  The route follows the input's dtype
(:func:`plan`):

* bfloat16 -> ``csrc/flash_attention_sm90.cu``: wgmma on the tensor cores,
  fed by TMA through an mbarrier ring.  A bf16 input that kernel cannot
  take (a base pointer or stride not 16-byte aligned, D not a multiple of
  16) raises ``ValueError`` with the reason; it is never sent elsewhere.
* float32 -> ``csrc/flash_attention.cu`` on the CUDA cores: the tensor
  cores' f32 mode is TF32 (10 bits of mantissa), which cannot hold an f32
  result to the sweep's 3e-5.

Both kernels take strides over (b, h, s) with D contiguous, so the model's
(B, S, H, D) activations go in as transposed views without a copy; the
output is allocated with q's strides (``torch.empty_like``), so it comes
back in the same layout.  The launcher checks its inputs, plans, allocates
the output and launches on the current stream; `kernels/ops.py` is the
public, dispatching wrapper.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import build

D_MAX = 256
SMEM_MAX = 232_448          # dynamic shared memory a block can use (H100)
TENSOR_CORES, CUDA_CORES = "tensor_cores", "cuda_cores"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2**31 - 1
_STRIDE_MAX = 2**39         # TMA strides stay under 2^40 bytes


class Plan(NamedTuple):
    route: str              # TENSOR_CORES (bf16) or CUDA_CORES (f32)
    block_q: int            # query rows of a block
    block_k: int            # keys of a kv tile
    stages: int             # K/V buffers in the ring (1: no ring)
    threads: int
    grid: Tuple[int, int, int]
    smem_bytes: int         # dynamic shared memory of a block
    refused: Optional[str]  # why the route cannot take this input, or None


def _sm90_smem(d: int, stages: int) -> int:
    dpad = -(-d // 64) * 64
    # 1024 bytes of alignment slack, Q (128 rows), the K and V stages of 64
    # keys, 128 bytes of mbarriers (csrc/flash_attention_sm90.cu)
    return 1024 + 2 * dpad * 128 + stages * 2 * (2 * dpad * 64) + 128


def _f32_smem(d: int) -> int:
    dmax = 64 if d <= 64 else 128 if d <= 128 else 256
    # q, k, v tiles of 64 rows at pitch dmax + 4 and the 64 x 68 probability
    # tile, all f32 (csrc/flash_attention.cu)
    return 4 * (3 * 64 * (dmax + 4) + 64 * 68)


def plan(q_shape: Sequence[int], k_shape: Sequence[int], dtype: torch.dtype,
         strides: Sequence[int], ptrs: Sequence[int]) -> Plan:
    """The launch for q (B, Hq, Sq, D) and k/v (B, Hkv, Sk, D) of ``dtype``:
    ``strides`` holds the (b, h, s) element strides of q, k and v (9
    values), ``ptrs`` their three base addresses.  bf16 takes the
    tensor-core kernel, as many ring stages (at most 4) as fit the shared
    memory, or is refused with the reason; f32 takes the CUDA-core kernel."""
    b, hq, sq, d = q_shape
    if dtype == torch.float32:
        return Plan(CUDA_CORES, 64, 64, 1, 256, (-(-sq // 64), hq, b),
                    _f32_smem(d), None)
    if dtype != torch.bfloat16:
        raise TypeError(f"flash_attention: no route for {dtype}")
    q_stage = _sm90_smem(d, 0)
    stage = _sm90_smem(d, 1) - q_stage
    stages = max(1, min(4, (SMEM_MAX - q_stage) // stage))
    pl = Plan(TENSOR_CORES, 128, 64, stages, 384, (-(-sq // 128), hq, b),
              _sm90_smem(d, stages), None)
    extents = ((b, hq, sq), (k_shape[0], k_shape[1], k_shape[2]),
               (k_shape[0], k_shape[1], k_shape[2]))
    reason = None
    if d % 16:
        reason = f"D={d} is not a multiple of 16 (the wgmma depth)"
    elif pl.smem_bytes > SMEM_MAX:
        reason = f"{pl.smem_bytes} bytes of shared memory exceed {SMEM_MAX}"
    for name, ptr, ext, st in zip("qkv", ptrs, extents,
                                  (strides[0:3], strides[3:6],
                                   strides[6:9])):
        if reason:
            break
        if ptr % 16:
            reason = (f"{name}'s base address is {ptr % 16} bytes past a "
                      f"16-byte boundary (TMA needs 16)")
            break
        for n, s in zip(ext, st):
            if n > 1 and (s <= 0 or s % 8 or 2 * s >= _STRIDE_MAX):
                reason = (f"{name}'s strides {tuple(st)} over (b, h, s) are "
                          f"not positive multiples of 8 elements (TMA "
                          f"needs 16-byte strides)")
                break
    return pl._replace(refused=reason)


def tma_strides(t: torch.Tensor) -> Tuple[int, int, int]:
    """(b, h, s) strides of t, with a size-1 dimension's (never stepped
    over, and free in PyTorch) set to D so that it meets TMA's rule."""
    return tuple(s if n > 1 else t.shape[3]
                 for n, s in zip(t.shape[:3], t.stride()[:3]))


@functools.lru_cache(maxsize=None)
def _fn_f32():
    fn = build.load("flash_attention").flash_attention_fwd
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                      ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _fn_sm90():
    fn = build.load("flash_attention_sm90").flash_attention_sm90_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                      ctypes.c_float, ctypes.c_float, ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
           window: int, softcap: float) -> None:
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: q on {q.device}, k on {k.device}, "
                         f"v on {v.device}; all must be on one CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must share a dtype in "
                        f"{tuple(_DTYPES)}, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: want q (B, Hq, Sq, D) and k, v "
                         f"(B, Hkv, Sk, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or hkv < 1 or hq % hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)} do not agree (batch, D, or Hq not "
                         f"a multiple of Hkv)")
    if not 1 <= d <= D_MAX or min(b, sq, sk) < 1:
        raise ValueError(f"flash_attention: D={d} outside [1, {D_MAX}] or an "
                         f"empty input ({tuple(q.shape)}, {tuple(k.shape)})")
    if causal and sq > sk:
        raise ValueError(f"flash_attention: causal with Sq={sq} > Sk={sk} "
                         f"leaves query rows with no key")
    if window < 0 or softcap < 0:
        raise ValueError(f"flash_attention: window={window} and "
                         f"softcap={softcap} must be >= 0")
    if max(b, hq, sq, sk, window) > _INT_MAX:
        raise ValueError("flash_attention: a size does not fit an int32")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention: {name} must have its last "
                             f"(D) dimension contiguous, strides "
                             f"{t.stride()}")


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool, window: int, softcap: float
           ) -> Tuple[torch.Tensor, str]:
    """Launch the kernel of q's dtype on CUDA tensors; returns the output
    and the route taken.  Raises on a refused input or launch."""
    _check(q, k, v, causal, window, softcap)
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    st = [s for t in (q, k, v) for s in tma_strides(t)]
    pl = plan(q.shape, k.shape, q.dtype, st,
              [t.data_ptr() for t in (q, k, v)])
    if pl.refused:
        raise ValueError(f"flash_attention: the bf16 tensor-core kernel "
                         f"cannot take this input: {pl.refused}")
    out = torch.empty_like(q)       # q's layout; D stays contiguous
    strides = (ctypes.c_longlong * 12)(*st, *tma_strides(out))
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq,
            hkv, sq, sk, d, strides, int(causal), int(window),
            float(softcap), 1.0 / math.sqrt(d))
    with torch.cuda.device(q.device):     # launch on the tensors' device
        stream = torch.cuda.current_stream().cuda_stream
        if pl.route == TENSOR_CORES:
            err = _fn_sm90()(*args, pl.stages, pl.smem_bytes, stream)
        else:
            err = _fn_f32()(_DTYPES[q.dtype], *args, stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: "
                           f"{'a tensor map was refused' if err == -1 else f'CUDA error {err}'} "
                           f"(q {tuple(q.shape)}, k {tuple(k.shape)}, "
                           f"{q.dtype}, causal={causal}, window={window}, "
                           f"{pl})")
    return out, pl.route
