"""The four assigned input shapes, which (arch, shape) pairs run, and the
KV-cache length a layer needs.  The port's copy of
``repro/configs/shapes.py``.

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
from typing import Tuple

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

# long_500k: only archs whose decode state is bounded (SSM / windowed)
_LONG_OK = {
    "mamba2-1.3b",        # SSM: O(1) state
    "recurrentgemma-2b",  # RG-LRU state + local-window attn
    "h2o-danube-1.8b",    # SWA: cache bounded at window
    "mixtral-8x22b",      # SWA
    "gemma2-2b",          # local layers windowed; global layers full cache
}

_LONG_SKIP_REASON = {
    "grok-1-314b": "pure full attention; no windowed variant implemented",
    "granite-3-8b": "pure full attention; no windowed variant implemented",
    "qwen2-72b": "pure full attention; no windowed variant implemented",
    "pixtral-12b": "pure full attention; no windowed variant implemented",
    "whisper-large-v3": "enc-dec decoder targets ~448 tokens; 500k decode meaningless",
}


def shape_applicable(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    """(runs?, reason-if-skipped) for an (arch, shape) pair."""
    if shape.name == "long_500k" and cfg.name not in _LONG_OK:
        return False, _LONG_SKIP_REASON.get(cfg.name, "full attention")
    return True, ""


def effective_cache_len(cfg: ModelConfig, kind: str, seq_len: int) -> int:
    """KV-cache length a decode step actually needs for a layer kind."""
    if kind in ("swa", "local"):
        return min(cfg.window_size, seq_len)
    return seq_len
