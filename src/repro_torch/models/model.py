"""Public model API: init / loss / prefill / decode for a ``ModelConfig``.
Counterpart of ``repro/models/model.py``: the layer the FL step and the
launchers consume.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.sharding import parallel as P
from repro_torch.tree import tree_leaves


def init_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """Random parameters in ``cfg.dtype`` on the generator's device."""
    return T.init_params(cfg, gen)


def init_caches(cfg: ModelConfig, batch: int, max_len: int, dtype,
                device, quantized: bool = False, tp=None) -> dict:
    return T.init_caches(cfg, batch, max_len, dtype, device,
                         quantized=quantized, tp=tp)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None, *, tp=None
                  ) -> torch.Tensor:
    """Mean next-token cross-entropy in float32.  logits (B, S, V), labels
    (B, S).  With ``tp`` the logits are this rank's slice of a
    vocab-sharded (B, S, V) (`sharding/parallel.TP`): the max, the sum of
    exp and the target logit are all-reduced over "model" in float32."""
    logits = logits.float()
    if tp is None or tp.size == 1:
        logz = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    else:
        v = logits.shape[-1]
        m = P.max_over_model(tp, logits.amax(-1))
        sumexp = P.reduce_from_model(
            tp, torch.exp(logits - m[..., None]).sum(-1))
        logz = m + torch.log(sumexp)
        local = labels.long() - tp.rank * v
        inside = (local >= 0) & (local < v)
        ll = torch.gather(logits, -1, local.clamp(0, v - 1)[..., None])[..., 0]
        ll = P.reduce_from_model(tp, torch.where(inside, ll, 0.0))
    nll = logz - ll
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def loss_fn(cfg: ModelConfig, params: dict, batch: Dict, *,
            dispatch: str = "dense", remat: bool = False,
            aux_weight: float = 0.01, tp=None) -> Tuple[torch.Tensor, dict]:
    """Training loss: next-token CE of ``logits[:, :-1]`` against
    ``labels[:, 1:]``, plus ``aux_weight`` times the MoE load-balance loss
    summed over layers (0 without MoE; ``dispatch`` is the MoE dispatch).
    ``batch`` needs "tokens" and "labels" (B, S), and an enc-dec model's
    "frames" (encoded in train mode, the chunked route) or a vision
    model's "patch_embeds": the CE then covers the text positions only.
    Returns (loss, {"ce", "aux"}).  ``tp`` runs the mesh program
    (`sharding/parallel.TP`): the loss of this rank's rows, vocab-parallel
    where the logits are a slice of the vocab."""
    logits, _, aux = T.forward(cfg, params, batch, mode="train",
                               dispatch=dispatch, remat=remat, tp=tp)
    if cfg.frontend == "vision" and "patch_embeds" in batch:
        # loss only over the text positions (suffix of the sequence)
        logits = logits[:, batch["patch_embeds"].shape[1]:]
    sharded = logits.shape[-1] != cfg.vocab_padded
    ce = cross_entropy(logits[:, :-1], batch["labels"][:, 1:],
                       tp=tp if sharded else None)
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


def _fresh_caches(cfg, params, tokens, max_len, quantized, tp=None):
    dtype = tree_leaves(params)[0].dtype
    return T.init_caches(cfg, tokens.shape[0], max_len, dtype, tokens.device,
                         quantized=quantized, tp=tp)


def prefill(cfg: ModelConfig, params: dict, batch: Dict, max_len: int,
            dispatch: str = "dense", quantized_cache: bool = False
            ) -> Tuple[torch.Tensor, dict]:
    """Full-sequence forward that also fills the KV caches (int8 ones if
    ``quantized_cache``).  ``batch`` holds "tokens" and, for a front end,
    "frames" or "enc_out" (enc-dec) or "patch_embeds" (vision: the caches
    then hold frontend_len + S positions, so ``max_len`` counts the
    patches)."""
    logits, caches, _ = T.forward(
        cfg, params, batch, mode="prefill", dispatch=dispatch,
        caches=_fresh_caches(cfg, params, batch["tokens"], max_len,
                             quantized_cache))
    return logits, caches


def prefill_last(cfg: ModelConfig, params: dict, batch: Dict, max_len: int,
                 dispatch: str = "dense", quantized_cache: bool = False,
                 tp=None) -> Tuple[torch.Tensor, dict]:
    """Serving prefill: caches + last-position logits (B, V) only;
    ``batch`` as :func:`prefill`'s.  On a mesh (``tp``) the rank's rows
    of the batch, its blocks of the caches and its slice of the vocab's
    logits, (B, V_padded / model) where the vocab is sharded, as the
    reference's ``out_shardings``."""
    logits, caches, _ = T.forward(
        cfg, params, batch, mode="prefill", dispatch=dispatch,
        caches=_fresh_caches(cfg, params, batch["tokens"], max_len,
                             quantized_cache, tp),
        last_only=True, tp=tp)
    return logits[:, 0], caches


def decode_step(cfg: ModelConfig, params: dict, caches: dict,
                token: torch.Tensor, pos,
                enc_out: Optional[torch.Tensor] = None,
                dispatch: str = "dense", tp=None
                ) -> Tuple[torch.Tensor, dict]:
    """One-token decode.  token (B, 1) int, pos the absolute position of
    ``token`` (an int or a 0-d tensor; after a vision prompt it counts the
    patches), ``enc_out`` an enc-dec model's encoder output (B,
    frontend_len, d_model).  Returns (logits (B, 1, V), caches), the caches
    updated in place (an int8 cache stays int8).  On a mesh (``tp``) as
    :func:`prefill_last`: vocab-sharded logits."""
    batch = {"tokens": token, "pos": pos}
    if enc_out is not None:
        batch["enc_out"] = enc_out
    logits, caches, _ = T.forward(cfg, params, batch, mode="decode",
                                  caches=caches, dispatch=dispatch, tp=tp)
    return logits, caches


def param_count(params) -> int:
    return sum(x.numel() for x in tree_leaves(params))
