"""Transformer stack over a cycled layer pattern.  Counterpart of
``repro/models/transformer.py``.

The parameter tree is the reference's: one stacked tree per position of
``layer_pattern`` with the cycle as its leading dimension
(``params["layers"][j]``), the ``num_layers % len(pattern)`` leftover layers
unstacked in ``params["rem_layers"]``, then ``embed`` and ``final_norm``.
The reference scans over the cycles; here a Python loop walks them through
views of the stacked leaves, so caches written in place land in the stacked
cache tensors.  In train mode with ``remat`` each cycle runs under
``torch.utils.checkpoint`` (non-reentrant), the reference's
``jax.checkpoint`` of its scan body: its activations are recomputed in the
backward pass instead of kept.

The port covers the attention layer kinds (attn, swa, local, global) with
a dense gated MLP and optional post-norms (gemma2-2b, h2o-danube-1.8b,
granite-3-8b, qwen2-72b and pixtral-12b's text stack) or a
mixture-of-experts layer in its place (``models/moe.py``: grok-1-314b,
mixtral-8x22b; ``dispatch`` picks dense, capacity or scan, and the
layers' load-balance losses are summed into ``forward``'s third value),
and the recurrent kinds: Mamba-2 SSD blocks (``models/ssm.py``; no MLP,
no second norm: mamba2-1.3b) and RG-LRU blocks (``models/rglru.py``, with
the MLP: recurrentgemma-2b, beside its local attention layers).  An
attention layer's cache may be int8 with per-row scales
(``init_caches(quantized=True)``, ``models/attention.py``).
Encoder-decoder models and modality front ends (whisper-large-v3,
pixtral-12b's vision input) raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ATTN_KINDS, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

_LATER = "(ROADMAP queue 1, item 16b, the rest of the transformer shelf)"


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.is_enc_dec or cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder and modality front ends are not in "
            f"the port's serving slice {_LATER}")


# --------------------------------------------------------------------------
# Block init/apply
# --------------------------------------------------------------------------

def init_block(cfg, kind: str, gen, dtype, device, lead=()) -> dict:
    """One block's parameters, with a leading ``lead`` shape (the cycle
    dimension of a stacked pattern position)."""
    p: Dict[str, Any] = {"norm1": L.init_norm(cfg, dtype, device, lead)}
    if kind in ATTN_KINDS:
        p["attn"] = attn.init_attention(cfg, gen, dtype, device, lead)
    elif kind == "rglru":
        p["rglru"] = rglru_lib.init_rglru(cfg, gen, dtype, device, lead)
    elif kind == "ssd":
        p["ssd"] = ssm_lib.init_ssd(cfg, gen, dtype, device, lead)
    else:
        raise ValueError(kind)
    if kind != "ssd":                                   # mamba2 has no MLP
        p["norm2"] = L.init_norm(cfg, dtype, device, lead)
        if cfg.num_experts:
            p["moe"] = moe_lib.init_moe(cfg, gen, dtype, device, lead)
        else:
            p["mlp"] = L.init_mlp(cfg, gen, dtype, device, lead)
    if cfg.post_norm:
        p["postnorm1"] = L.init_norm(cfg, dtype, device, lead)
        if kind != "ssd":
            p["postnorm2"] = L.init_norm(cfg, dtype, device, lead)
    return p


def apply_block(cfg, kind: str, p: dict, x, *, mode: str, positions,
                cache=None, dispatch: str = "dense"):
    """Returns (x, cache, aux): the cache written in place, ``aux`` the MoE
    layer's f32 load-balance loss, or None without one (the reference's 0,
    which ``forward`` does not add)."""
    aux = None
    h = L.apply_norm(cfg, p["norm1"], x)
    if kind in ATTN_KINDS:
        h, new_cache = attn.apply_attention(cfg, p["attn"], h, kind=kind,
                                            mode=mode, positions=positions,
                                            cache=cache)
    elif kind == "rglru":
        h, new_cache = rglru_lib.apply_rglru(cfg, p["rglru"], h, mode=mode,
                                             cache=cache)
    elif kind == "ssd":
        h, new_cache = ssm_lib.apply_ssd(cfg, p["ssd"], h, mode=mode,
                                         cache=cache)
    else:
        raise ValueError(kind)
    if cfg.post_norm:
        h = L.apply_norm(cfg, p["postnorm1"], h)
    x = x + h
    if kind == "ssd":
        return x, new_cache, aux
    h = L.apply_norm(cfg, p["norm2"], x)
    if cfg.num_experts:
        h, aux = moe_lib.apply_moe(cfg, p["moe"], h, dispatch)
    else:
        h = L.apply_mlp(cfg, p["mlp"], h)
    if cfg.post_norm:
        h = L.apply_norm(cfg, p["postnorm2"], h)
    return x + h, new_cache, aux


# --------------------------------------------------------------------------
# Parameters and caches
# --------------------------------------------------------------------------

def init_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """Random parameters from ``gen``, in the config's dtype, on the
    generator's device."""
    _check_supported(cfg)
    dtype = getattr(torch, cfg.dtype)
    device = gen.device
    pat = cfg.layer_pattern
    n_cycles = cfg.num_layers // len(pat)
    rem = cfg.num_layers % len(pat)
    return {
        "embed": L.init_embed(cfg, gen, dtype, device),
        "layers": tuple(init_block(cfg, kind, gen, dtype, device, (n_cycles,))
                        for kind in pat),
        "rem_layers": tuple(init_block(cfg, pat[j], gen, dtype, device)
                            for j in range(rem)),
        "final_norm": L.init_norm(cfg, dtype, device),
    }


def init_caches(cfg: ModelConfig, batch: int, max_len: int, dtype,
                device, quantized: bool = False) -> dict:
    """Cache tree matching the layer structure (stacked over cycles): a
    ring-buffer KV cache for an attention layer (int8 with f32 scales if
    ``quantized``), the recurrent state for an SSD or RG-LRU layer."""
    pat = cfg.layer_pattern
    n_cycles = cfg.num_layers // len(pat)
    rem = cfg.num_layers % len(pat)

    def one(kind, lead=()):
        if kind in ATTN_KINDS:
            return attn.init_cache(cfg, kind, batch, max_len, dtype, device,
                                   quantized=quantized, lead=lead)
        if kind == "ssd":
            return ssm_lib.init_ssd_cache(cfg, batch, dtype, device, lead)
        return rglru_lib.init_rglru_cache(cfg, batch, dtype, device, lead)

    return {"layers": tuple(one(kind, (n_cycles,)) for kind in pat),
            "rem_layers": tuple(one(pat[j]) for j in range(rem))}


def params_from_numpy(tree: Any, device) -> Any:
    """A tree of numpy arrays (the reference's parameters, fetched leaf for
    leaf) as tensors on ``device``.  bfloat16 leaves (``ml_dtypes``, which
    ``torch.from_numpy`` refuses) go through a 16-bit view."""
    def one(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a.copy())
        return t.to(device)
    return tree_map(one, tree)


def params_to_numpy(tree: Any) -> Any:
    """Tensors -> numpy arrays; bfloat16 leaves come back as float32
    (numpy has no bfloat16 of its own)."""
    def one(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return tree_map(one, tree)


# --------------------------------------------------------------------------
# Forward pass
# --------------------------------------------------------------------------

def _cycles(tree: Any, n: int) -> list:
    """The ``n`` per-cycle views of a tree stacked over cycles (one
    ``unbind`` a leaf, so a gradient comes back as one stack)."""
    parts = [t.unbind(0) for t in tree_leaves(tree)]
    return [tree_unflatten(tree, [u[c] for u in parts]) for c in range(n)]


def forward(cfg: ModelConfig, params: dict, batch: dict, *, mode: str,
            caches: Optional[dict] = None, dispatch: str = "dense",
            last_only: bool = False, remat: bool = False
            ) -> Tuple[torch.Tensor, Optional[dict], torch.Tensor]:
    """Run the stack.  Returns (logits, caches, aux): the caches are the
    given ones, written in place; ``aux`` is the f32 sum over layers of the
    MoE load-balance losses (0 without MoE), in layer order as the
    reference's scan carry sums it.  ``dispatch`` is the MoE dispatch
    (``models/moe.py``).  ``batch`` holds
    "tokens" (B, S) and, in decode, "pos" (the absolute position of the one
    token).  ``last_only`` unembeds just the final position (serving
    prefill).  ``remat`` checkpoints each cycle of the layer pattern in
    train mode (the values are those of ``remat=False``)."""
    _check_supported(cfg)
    tokens = batch["tokens"]
    dev = tokens.device
    x = L.embed_tokens(cfg, params["embed"], tokens)
    if mode == "decode":
        positions = torch.as_tensor(batch["pos"], device=dev).reshape(1)
    else:
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=dev)
    positions = positions.to(torch.int32)
    pat = cfg.layer_pattern
    n_cycles = cfg.num_layers // len(pat)
    layers = [_cycles(lp, n_cycles) for lp in params["layers"]]

    def cycle(x, aux, c):
        for j, kind in enumerate(pat):
            cache = (None if caches is None
                     else tree_map(lambda t: t[c], caches["layers"][j]))
            x, _, a = apply_block(cfg, kind, layers[j][c], x, mode=mode,
                                  positions=positions, cache=cache,
                                  dispatch=dispatch)
            if a is not None:
                aux = aux + a
        return x, aux

    aux = torch.zeros((), dtype=torch.float32, device=dev)
    for c in range(n_cycles):
        if remat and mode == "train":
            x, aux = torch.utils.checkpoint.checkpoint(cycle, x, aux, c,
                                                       use_reentrant=False)
        else:
            x, aux = cycle(x, aux, c)
    for j, lp in enumerate(params["rem_layers"]):
        cache = None if caches is None else caches["rem_layers"][j]
        x, _, a = apply_block(cfg, pat[j % len(pat)], lp, x, mode=mode,
                              positions=positions, cache=cache,
                              dispatch=dispatch)
        if a is not None:
            aux = aux + a

    x = L.apply_norm(cfg, params["final_norm"], x)
    if last_only:
        x = x[:, -1:]
    logits = L.unembed(cfg, params["embed"], x)
    return logits, caches, aux
