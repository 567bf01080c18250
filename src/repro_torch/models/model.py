"""Public model API: init / loss / prefill / decode for a ``ModelConfig``.
Counterpart of ``repro/models/model.py``: the layer the FL step and the
launchers consume.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves


def init_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """Random parameters in ``cfg.dtype`` on the generator's device."""
    return T.init_params(cfg, gen)


def init_caches(cfg: ModelConfig, batch: int, max_len: int, dtype,
                device) -> dict:
    return T.init_caches(cfg, batch, max_len, dtype, device)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross-entropy in float32.  logits (B, S, V), labels
    (B, S)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - ll
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def loss_fn(cfg: ModelConfig, params: dict, batch: Dict, *,
            dispatch: str = "dense", remat: bool = False,
            aux_weight: float = 0.01) -> Tuple[torch.Tensor, dict]:
    """Training loss: next-token CE of ``logits[:, :-1]`` against
    ``labels[:, 1:]`` (+ the MoE aux loss, 0 until MoE is ported; so
    ``dispatch`` selects nothing yet).  ``batch`` needs "tokens" and
    "labels" (B, S).  A vision front end raises in ``T.forward``, as the
    serving path does.  Returns (loss, {"ce", "aux"})."""
    logits, _ = T.forward(cfg, params, batch, mode="train", remat=remat)
    aux = torch.zeros((), dtype=torch.float32, device=logits.device)
    ce = cross_entropy(logits[:, :-1], batch["labels"][:, 1:])
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


def _fresh_caches(cfg, params, tokens, max_len):
    dtype = tree_leaves(params)[0].dtype
    return T.init_caches(cfg, tokens.shape[0], max_len, dtype, tokens.device)


def prefill(cfg: ModelConfig, params: dict, batch: Dict, max_len: int
            ) -> Tuple[torch.Tensor, dict]:
    """Full-sequence forward that also fills the KV caches."""
    logits, caches = T.forward(
        cfg, params, batch, mode="prefill",
        caches=_fresh_caches(cfg, params, batch["tokens"], max_len))
    return logits, caches


def prefill_last(cfg: ModelConfig, params: dict, batch: Dict, max_len: int
                 ) -> Tuple[torch.Tensor, dict]:
    """Serving prefill: caches + last-position logits (B, V) only."""
    logits, caches = T.forward(
        cfg, params, batch, mode="prefill",
        caches=_fresh_caches(cfg, params, batch["tokens"], max_len),
        last_only=True)
    return logits[:, 0], caches


def decode_step(cfg: ModelConfig, params: dict, caches: dict,
                token: torch.Tensor, pos) -> Tuple[torch.Tensor, dict]:
    """One-token decode.  token (B, 1) int, pos the absolute position of
    ``token`` (an int or a 0-d tensor).  Returns (logits (B, 1, V), caches),
    the caches updated in place."""
    logits, caches = T.forward(cfg, params, {"tokens": token, "pos": pos},
                               mode="decode", caches=caches)
    return logits, caches


def param_count(params) -> int:
    return sum(x.numel() for x in tree_leaves(params))
