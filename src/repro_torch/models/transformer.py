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

Encoder-decoder (whisper-large-v3): every decoder block carries a
cross-attention layer over the encoder's output (``norm_cross``,
``cross``), and ``params["encoder"]`` holds the encoder's stacked
non-causal attention blocks and its final norm beside ``enc_pos``, the
learned positions added to the (stubbed) front end's frames.
:func:`encode` runs the encoder in the mode its caller names: "train"
(the chunked route autograd differentiates) or "prefill" (the flash
kernel); ``forward`` encodes ``batch["frames"]`` itself (in "train" mode
for a train forward, in "prefill" otherwise) unless ``batch["enc_out"]``
is given.  The vision front end (pixtral-12b): ``params["proj"]`` maps
``batch["patch_embeds"]`` (B, frontend_len, d_model) into the model's
width, and the patches go in front of the text, so positions and caches
count them.
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
from repro_torch.sharding import parallel as P
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


# --------------------------------------------------------------------------
# Block init/apply
# --------------------------------------------------------------------------

def init_block(cfg, kind: str, gen, dtype, device, lead=(),
               cross: bool = False) -> dict:
    """One block's parameters, with a leading ``lead`` shape (the cycle
    dimension of a stacked pattern position); ``cross`` adds an enc-dec
    decoder block's cross-attention and its norm."""
    p: Dict[str, Any] = {"norm1": L.init_norm(cfg, dtype, device, lead)}
    if kind in ATTN_KINDS:
        p["attn"] = attn.init_attention(cfg, gen, dtype, device, lead)
    elif kind == "rglru":
        p["rglru"] = rglru_lib.init_rglru(cfg, gen, dtype, device, lead)
    elif kind == "ssd":
        p["ssd"] = ssm_lib.init_ssd(cfg, gen, dtype, device, lead)
    else:
        raise ValueError(kind)
    if cross:
        p["norm_cross"] = L.init_norm(cfg, dtype, device, lead)
        p["cross"] = attn.init_attention(cfg, gen, dtype, device, lead,
                                         cross=True)
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
                cache=None, enc_out=None, causal: bool = True,
                dispatch: str = "dense", tp=None):
    """Returns (x, cache, aux): the cache written in place, ``aux`` the MoE
    layer's f32 load-balance loss, or None without one (the reference's 0,
    which ``forward`` does not add).  A block with a cross-attention layer
    attends over ``enc_out`` after its self-attention; ``causal=False`` is
    the encoder's self-attention.  ``tp`` (`sharding/parallel.TP`) runs
    the block's mesh program: its attention, cross-attention, recurrent,
    MLP or MoE layer on this rank's blocks."""
    aux = None
    h = L.apply_norm(cfg, p["norm1"], x)
    if kind in ATTN_KINDS:
        h, new_cache = attn.apply_attention(cfg, p["attn"], h, kind=kind,
                                            mode=mode, positions=positions,
                                            cache=cache, causal=causal,
                                            tp=tp)
    elif kind == "rglru":
        h, new_cache = rglru_lib.apply_rglru(cfg, p["rglru"], h, mode=mode,
                                             cache=cache, tp=tp)
    elif kind == "ssd":
        h, new_cache = ssm_lib.apply_ssd(cfg, p["ssd"], h, mode=mode,
                                         cache=cache, tp=tp)
    else:
        raise ValueError(kind)
    if cfg.post_norm:
        h = L.apply_norm(cfg, p["postnorm1"], h)
    x = x + h
    if "cross" in p:                                    # enc-dec decoder
        h = L.apply_norm(cfg, p["norm_cross"], x)
        h, _ = attn.apply_attention(cfg, p["cross"], h, kind="attn",
                                    mode=mode, positions=positions,
                                    kv_x=enc_out, tp=tp)
        x = x + h
    if kind == "ssd":
        return x, new_cache, aux
    h = L.apply_norm(cfg, p["norm2"], x)
    if cfg.num_experts:
        h, aux = moe_lib.apply_moe(cfg, p["moe"], h, dispatch, tp=tp)
    else:
        h = L.apply_mlp(cfg, p["mlp"], h, tp)
    if cfg.post_norm:
        h = L.apply_norm(cfg, p["postnorm2"], h)
    return x + h, new_cache, aux


# --------------------------------------------------------------------------
# Parameters and caches
# --------------------------------------------------------------------------

def init_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """Random parameters from ``gen``, in the config's dtype, on the
    generator's device: the reference's tree, with an enc-dec model's
    ``encoder`` and ``enc_pos`` (scale 0.02) and a vision model's
    ``proj`` (scale d_model^-0.5)."""
    dtype = getattr(torch, cfg.dtype)
    device = gen.device
    pat = cfg.layer_pattern
    n_cycles = cfg.num_layers // len(pat)
    rem = cfg.num_layers % len(pat)
    cross = cfg.is_enc_dec
    params = {
        "embed": L.init_embed(cfg, gen, dtype, device),
        "layers": tuple(init_block(cfg, kind, gen, dtype, device, (n_cycles,),
                                   cross=cross)
                        for kind in pat),
        "rem_layers": tuple(init_block(cfg, pat[j], gen, dtype, device,
                                       cross=cross)
                            for j in range(rem)),
        "final_norm": L.init_norm(cfg, dtype, device),
    }
    if cfg.is_enc_dec:
        params["encoder"] = {
            "layers": (init_block(cfg, "attn", gen, dtype, device,
                                  (cfg.encoder_layers,)),),
            "final_norm": L.init_norm(cfg, dtype, device)}
        params["enc_pos"] = L._init(gen, (cfg.frontend_len, cfg.d_model),
                                    0.02, dtype, device)
    if cfg.frontend == "vision":
        # projector stub: pre-extracted patch features -> d_model
        params["proj"] = L._init(gen, (cfg.d_model, cfg.d_model),
                                 cfg.d_model ** -0.5, dtype, device)
    return params


def init_caches(cfg: ModelConfig, batch: int, max_len: int, dtype,
                device, quantized: bool = False, tp=None) -> dict:
    """Cache tree matching the layer structure (stacked over cycles): a
    ring-buffer KV cache for an attention layer (int8 with f32 scales if
    ``quantized``), the recurrent state for an SSD or RG-LRU layer.  On a
    mesh (``tp``) an attention cache holds this rank's block of slots
    where the "model" size divides them (``slot_pos`` stays whole), the
    reference's placement, and a recurrent layer's state its heads or
    channels where they divide (`launch/steps.cache_spec_tree`);
    ``batch`` is the rank's own rows."""
    pat = cfg.layer_pattern
    n_cycles = cfg.num_layers // len(pat)
    rem = cfg.num_layers % len(pat)

    def one(kind, lead=()):
        if kind in ATTN_KINDS:
            return attn.init_cache(cfg, kind, batch, max_len, dtype, device,
                                   quantized=quantized, lead=lead,
                                   shards=P.model_size(tp))
        if kind == "ssd":
            return ssm_lib.init_ssd_cache(cfg, batch, dtype, device, lead,
                                          shards=P.model_size(tp))
        return rglru_lib.init_rglru_cache(cfg, batch, dtype, device, lead,
                                          shards=P.model_size(tp))

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


def encode(cfg: ModelConfig, params: dict, frames: torch.Tensor,
           remat: bool = False, mode: str = "train", tp=None
           ) -> torch.Tensor:
    """Whisper-style encoder over precomputed frame embeddings (the stubbed
    front end): frames (B, frontend_len, d_model) -> (B, frontend_len,
    d_model), cast to the parameters' dtype before ``enc_pos`` is added.
    ``mode`` picks the attention route: "train" (chunked, differentiable;
    what the reference always runs) or "prefill" (the flash kernel, for
    serving).  ``remat`` checkpoints each layer in train mode.  ``tp``
    runs the non-causal blocks' mesh program on this rank's blocks;
    ``enc_pos`` is replicated (the reference's rules), and so is the
    output."""
    enc = params["encoder"]
    x = frames.to(params["enc_pos"].dtype) + params["enc_pos"]
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)

    def layer(x, lp):
        return apply_block(cfg, "attn", lp, x, mode=mode,
                           positions=positions, causal=False, tp=tp)[0]

    for lp in _cycles(enc["layers"][0], cfg.encoder_layers):
        if remat and mode == "train":
            x = torch.utils.checkpoint.checkpoint(layer, x, lp,
                                                  use_reentrant=False)
        else:
            x = layer(x, lp)
    return L.apply_norm(cfg, enc["final_norm"], x)


def project_patches(cfg, w, patch_embeds, tp=None):
    """The vision front end's patches in the model's width, ``patch_embeds
    @ proj``.  On a mesh ``proj`` (d, d) is column-parallel over "model"
    (gathered over "data" under FSDP), the reference's (fsdp, tp), and the
    rank's columns are gathered whole (`parallel.gather_whole`) before
    they join the replicated residual stream."""
    w = P.fsdp_gather(tp, w, -2, cfg.d_model)
    if not P.is_split(w.shape[-1], cfg.d_model):
        return patch_embeds @ w
    return P.gather_whole(tp, P.copy_to_model(tp, patch_embeds) @ w, -1)


def _embed_inputs(cfg, params, batch, mode, remat=False, tp=None):
    """(x, positions, enc_out): the tokens' embeddings with a vision
    prompt's projected patches in front, their absolute positions (in
    decode, ``batch["pos"]``), and an enc-dec model's encoder output
    (``batch["enc_out"]``, or ``batch["frames"]`` encoded here)."""
    tokens = batch["tokens"]
    dev = tokens.device
    x = L.embed_tokens(cfg, params["embed"], tokens, tp)
    if mode == "decode":
        positions = torch.as_tensor(batch["pos"], device=dev).reshape(1)
    else:
        positions = torch.arange(tokens.shape[1], device=dev)
    if cfg.frontend == "vision" and "patch_embeds" in batch:
        pe = project_patches(cfg, params["proj"],
                             batch["patch_embeds"].to(x.dtype), tp)
        x = torch.cat([pe, x], 1)
        if mode != "decode":
            positions = torch.arange(x.shape[1], device=dev)
    enc_out = None
    if cfg.is_enc_dec:
        enc_out = batch.get("enc_out")
        if enc_out is None:
            enc_out = encode(cfg, params, batch["frames"], remat=remat,
                             mode="train" if mode == "train" else "prefill",
                             tp=tp)
    return x, positions.to(torch.int32), enc_out


def forward(cfg: ModelConfig, params: dict, batch: dict, *, mode: str,
            caches: Optional[dict] = None, dispatch: str = "dense",
            last_only: bool = False, remat: bool = False, tp=None
            ) -> Tuple[torch.Tensor, Optional[dict], torch.Tensor]:
    """Run the stack.  Returns (logits, caches, aux): the caches are the
    given ones, written in place; ``aux`` is the f32 sum over layers of the
    MoE load-balance losses (0 without MoE), in layer order as the
    reference's scan carry sums it.  ``dispatch`` is the MoE dispatch
    (``models/moe.py``).  ``batch`` holds
    "tokens" (B, S) and, in decode, "pos" (the absolute position of the one
    token).  ``last_only`` unembeds just the final position (serving
    prefill).  ``remat`` checkpoints each cycle of the layer pattern in
    train mode (the values are those of ``remat=False``).  An enc-dec
    model reads "enc_out" (B, frontend_len, d_model) or "frames" from
    ``batch``, a vision model "patch_embeds" (B, frontend_len, d_model):
    its logits then cover frontend_len + S positions (:func:`_embed_inputs`).
    ``tp`` (`sharding/parallel.TP`) runs the mesh program on this rank's
    blocks of ``params`` and ``caches``: the logits are then its slice of
    the vocab.
    """
    x, positions, enc_out = _embed_inputs(cfg, params, batch, mode, remat,
                                          tp)
    dev = x.device
    pat = cfg.layer_pattern
    n_cycles = cfg.num_layers // len(pat)
    layers = [_cycles(lp, n_cycles) for lp in params["layers"]]

    def cycle(x, aux, c):
        for j, kind in enumerate(pat):
            cache = (None if caches is None
                     else tree_map(lambda t: t[c], caches["layers"][j]))
            x, _, a = apply_block(cfg, kind, layers[j][c], x, mode=mode,
                                  positions=positions, cache=cache,
                                  enc_out=enc_out, dispatch=dispatch, tp=tp)
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
                              enc_out=enc_out, dispatch=dispatch, tp=tp)
        if a is not None:
            aux = aux + a

    x = L.apply_norm(cfg, params["final_norm"], x)
    if last_only:
        x = x[:, -1:]
    logits = L.unembed(cfg, params["embed"], x, tp)
    return logits, caches, aux
