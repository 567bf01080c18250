"""Launcher for the CUDA ``flash_attention`` kernel (``csrc/flash_attention.cu``).

Counterpart of ``repro/kernels/flash_attention.py::flash_attention`` (forward
only): q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D), float32 or bfloat16 ->
(B, Hq, Sq, D) in q's dtype.  The kernel takes strides over (b, h, s) with
D contiguous, so the model's (B, S, H, D) activations go in as transposed
views without a copy; the output is allocated with q's strides
(``torch.empty_like``), so it comes back in the same layout.  The launcher
checks its inputs, allocates the output and launches on the current stream;
`kernels/ops.py` is the public, dispatching wrapper.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build

D_MAX = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2**31 - 1


@functools.lru_cache(maxsize=None)
def _fn():
    fn = build.load("flash_attention").flash_attention_fwd
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                      ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
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
           causal: bool, window: int, softcap: float) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; raises on a refused launch."""
    _check(q, k, v, causal, window, softcap)
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)       # q's layout; D stays contiguous
    strides = (ctypes.c_longlong * 12)(*(
        s for t in (q, k, v, out) for s in t.stride()[:3]))
    with torch.cuda.device(q.device):     # launch on the tensors' device
        err = _fn()(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), out.data_ptr(), b, hq, hkv, sq, sk, d,
                    strides, int(causal), int(window), float(softcap),
                    1.0 / math.sqrt(d),
                    torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err} "
                           f"(q {tuple(q.shape)}, k {tuple(k.shape)}, "
                           f"{q.dtype}, causal={causal}, window={window})")
    return out
