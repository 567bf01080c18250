"""The four assigned input shapes and the KV-cache length a layer needs.

The port's copy of ``repro/configs/shapes.py``'s data; the per-(arch,
shape) applicability table comes with the launch slice.

Shapes (from the assignment):
    train_4k      seq_len=  4,096  global_batch=256   (training)
    prefill_32k   seq_len= 32,768  global_batch= 32   (inference-prefill)
    decode_32k    seq_len= 32,768  global_batch=128   (inference-decode:
                                                       ONE new token, KV cache
                                                       of seq_len)
    long_500k     seq_len=524,288  global_batch=  1   (long-context decode)
"""
from __future__ import annotations

from dataclasses import dataclass
from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str                 # "train" | "prefill" | "decode"


TRAIN_4K = InputShape("train_4k", 4096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32768, 128, "decode")
LONG_500K = InputShape("long_500k", 524288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}

def effective_cache_len(cfg: ModelConfig, kind: str, seq_len: int) -> int:
    """KV-cache length a decode step actually needs for a layer kind."""
    if kind in ("swa", "local"):
        return min(cfg.window_size, seq_len)
    return seq_len
