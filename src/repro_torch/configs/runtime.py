"""Per-architecture runtime profiles: how each arch is placed on the mesh,
microbatched, and dispatched.  The port's copy of
``repro/configs/runtime.py``; one ``<arch>.py`` module per assigned
architecture re-exports (CONFIG, PROFILE)."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class RunProfile:
    arch: str
    client_axis: str = "data"      # FL client placement: "data" | "pod"
    grad_accum: int = 1            # microbatch accumulation (train_4k)
    moe_dispatch: str = "dense"    # dense | capacity
    optimizer: str = "sgd"
    param_dtype: str = "bfloat16"
    remat: bool = True
    kv_int8: bool = False    # int8-quantized KV cache for serving
    accum_dtype: str = "float32"  # grad-accumulator dtype (bf16 halves the
    #                               dominant train-step memory term on the
    #                               300B-class MoEs)
