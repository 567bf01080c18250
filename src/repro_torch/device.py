"""Device resolution and float32 policy.

The reference runs strict float32 (JAX x64 off, no reduced-precision
matmuls), so this module turns TF32 off for both cuBLAS matmuls and cuDNN
convolutions.  There is no "CUDA if present, else CPU" helper: asking for
CUDA on a machine without it raises.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DeviceLike = Union[str, torch.device, None]


def resolve(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``.  Raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def peak_device_mem_mb(device: torch.device) -> Optional[float]:
    """Peak CUDA allocation in MB since the last reset; None on the CPU."""
    if device.type != "cuda":
        return None
    return round(torch.cuda.max_memory_allocated(device) / 1e6, 3)
