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
                device, quantized: bool = False) -> dict:
    return T.init_caches(cfg, batch, max_len, dtype, device,
                         quantized=quantized)


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
    ``labels[:, 1:]``, plus ``aux_weight`` times the MoE load-balance loss
    summed over layers (0 without MoE; ``dispatch`` is the MoE dispatch).
    ``batch`` needs "tokens" and "labels" (B, S).  A vision front end
    raises in ``T.forward``, as the serving path does.  Returns (loss,
    {"ce", "aux"})."""
    logits, _, aux = T.forward(cfg, params, batch, mode="train",
                               dispatch=dispatch, remat=remat)
    ce = cross_entropy(logits[:, :-1], batch["labels"][:, 1:])
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


def _fresh_caches(cfg, params, tokens, max_len, quantized):
    dtype = tree_leaves(params)[0].dtype
    return T.init_caches(cfg, tokens.shape[0], max_len, dtype, tokens.device,
                         quantized=quantized)


def prefill(cfg: ModelConfig, params: dict, batch: Dict, max_len: int,
            dispatch: str = "dense", quantized_cache: bool = False
            ) -> Tuple[torch.Tensor, dict]:
    """Full-sequence forward that also fills the KV caches (int8 ones if
    ``quantized_cache``)."""
    logits, caches, _ = T.forward(
        cfg, params, batch, mode="prefill", dispatch=dispatch,
        caches=_fresh_caches(cfg, params, batch["tokens"], max_len,
                             quantized_cache))
    return logits, caches


def prefill_last(cfg: ModelConfig, params: dict, batch: Dict, max_len: int,
                 dispatch: str = "dense", quantized_cache: bool = False
                 ) -> Tuple[torch.Tensor, dict]:
    """Serving prefill: caches + last-position logits (B, V) only."""
    logits, caches, _ = T.forward(
        cfg, params, batch, mode="prefill", dispatch=dispatch,
        caches=_fresh_caches(cfg, params, batch["tokens"], max_len,
                             quantized_cache),
        last_only=True)
    return logits[:, 0], caches


def decode_step(cfg: ModelConfig, params: dict, caches: dict,
                token: torch.Tensor, pos, dispatch: str = "dense"
                ) -> Tuple[torch.Tensor, dict]:
    """One-token decode.  token (B, 1) int, pos the absolute position of
    ``token`` (an int or a 0-d tensor).  Returns (logits (B, 1, V), caches),
    the caches updated in place (an int8 cache stays int8)."""
    logits, caches, _ = T.forward(cfg, params, {"tokens": token, "pos": pos},
                                  mode="decode", caches=caches,
                                  dispatch=dispatch)
    return logits, caches


def param_count(params) -> int:
    return sum(x.numel() for x in tree_leaves(params))
