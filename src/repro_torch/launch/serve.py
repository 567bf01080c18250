"""Batched greedy serving on one device: prefill a batch of prompts, then
decode with ring-buffer KV caches.

    python -m repro_torch.launch.serve --arch gemma2-2b \
        [--smoke] [--batch 2] [--prompt-len 64] [--tokens 16] \
        [--kv-int8 | --no-kv-int8] [--device cpu]

The port's counterpart of ``examples/serve_batch.py`` and, on one card, of
``launch/serve.py``: the full-size config by default (``--smoke`` takes its
``smoke_variant``), random weights from ``--seed``, on ``cuda`` unless
``--device cpu`` is asked for (no fallback).  Any arch the port's stack
covers: the attention models, the recurrent ones, ``mamba2-1.3b`` (SSD
state caches) and ``recurrentgemma-2b`` (RG-LRU states beside ring-buffer
caches for its local layers), and the mixtures of experts,
``grok-1-314b`` and ``mixtral-8x22b`` (a full-size one fits no single
card: serve its smoke variant, or a depth cut from Python).  The MoE
dispatch and the KV cache's type come from the arch's profile (grok-1:
scan dispatch, int8 cache; mixtral: scan, bf16); ``--kv-int8`` and
``--no-kv-int8`` override the cache.  The front ends: whisper-large-v3
(encoder-decoder) encodes ``0.1 * normal`` frames of (B, frontend_len,
d_model) drawn from ``--seed`` once, and every decoder layer attends over
the encoder's output in prefill and in each decode step; pixtral-12b
takes ``0.1 * normal`` patch embeddings of the same shape in front of the
prompt, so its caches and decode positions count frontend_len + S
positions.  Prints one JSON line with the timings (whisper's encode
apart), the cache's bytes, frontend_len and the first generated tokens.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import NamedTuple, Optional

import torch

from repro_torch import device as device_lib
from repro_torch.configs import get_config, get_profile, smoke_variant
from repro_torch.models import decode_step, init_params, param_count
from repro_torch.models.model import prefill_last
from repro_torch.models.transformer import encode
from repro_torch.tree import tree_leaves


class ServeResult(NamedTuple):
    tokens: torch.Tensor        # (B, new_tokens) greedy continuations, CPU
    prefill_s: float            # prefill of the whole batch, host clock
    decode_s: float             # the new_tokens - 1 decode steps
    decode_tokens_per_s: float  # B * (new_tokens - 1) / decode_s
    peak_device_mem_mb: Optional[float]
    cache_bytes: int            # the caches prefill made
    encode_s: float = 0.0       # an enc-dec model's encoder, host clock


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _frontend_input(cfg, x: Optional[torch.Tensor], name: str, b: int,
                    dev: torch.device) -> Optional[torch.Tensor]:
    """``x`` (B, frontend_len, d_model) on ``dev``, checked; None where the
    arch takes no such input.  An arch that needs one raises without it."""
    wants = cfg.is_enc_dec if name == "frames" else cfg.frontend == "vision"
    if x is None:
        if wants and name == "frames":
            raise ValueError(f"{cfg.name}: an encoder-decoder model needs "
                             f"frames (B, {cfg.frontend_len}, {cfg.d_model})")
        return None
    if not wants:
        raise ValueError(f"{cfg.name} takes no {name}")
    if tuple(x.shape) != (b, cfg.frontend_len, cfg.d_model):
        raise ValueError(f"{name} {tuple(x.shape)}: want ({b}, "
                         f"{cfg.frontend_len}, {cfg.d_model})")
    return x.to(dev)


def serve_batch(cfg, params: dict, prompts: torch.Tensor, new_tokens: int,
                *, device=None, dispatch: str = "dense",
                quantized_cache: bool = False,
                frames: Optional[torch.Tensor] = None,
                patch_embeds: Optional[torch.Tensor] = None) -> ServeResult:
    """Greedy continuation of ``prompts`` (B, S) by ``new_tokens`` tokens:
    one prefill (which gives the first new token), then ``new_tokens - 1``
    decode steps, with the MoE ``dispatch`` and, if ``quantized_cache``,
    int8 KV caches.  An enc-dec model's ``frames`` (B, frontend_len,
    d_model) are encoded once (``encode_s``, in "prefill" mode: the flash
    kernel), and the encoder's output goes to the prefill and to every
    decode step.  A vision model's ``patch_embeds`` go in front of the
    prompt: the caches hold frontend_len + S + new_tokens positions, and
    decode step i runs at position frontend_len + S + i.  Every timing
    ends in a device synchronize."""
    dev = device_lib.resolve(device)
    if new_tokens < 1:
        raise ValueError(f"new_tokens={new_tokens} must be >= 1")
    leaf = tree_leaves(params)[0]
    if leaf.device.type != dev.type:
        raise ValueError(f"params on {leaf.device}, serving on {dev}")
    prompts = prompts.to(dev)
    b, s = prompts.shape
    frames = _frontend_input(cfg, frames, "frames", b, dev)
    patch_embeds = _frontend_input(cfg, patch_embeds, "patch_embeds", b, dev)
    batch = {"tokens": prompts}
    start = s                       # the position of the first new token
    if patch_embeds is not None:
        batch["patch_embeds"] = patch_embeds
        start += cfg.frontend_len
    max_len = start + new_tokens
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    enc_out = None
    with torch.inference_mode():
        _sync(dev)
        t0 = time.perf_counter()
        if frames is not None:
            enc_out = encode(cfg, params, frames, mode="prefill")
            batch["enc_out"] = enc_out
        _sync(dev)
        t1 = time.perf_counter()
        logits, caches = prefill_last(cfg, params, batch, max_len,
                                      dispatch=dispatch,
                                      quantized_cache=quantized_cache)
        tok = logits.argmax(-1)[:, None]
        _sync(dev)
        t2 = time.perf_counter()
        out = [tok]
        for i in range(new_tokens - 1):
            logits, caches = decode_step(cfg, params, caches, tok, start + i,
                                         enc_out=enc_out, dispatch=dispatch)
            tok = logits[:, 0].argmax(-1)[:, None]
            out.append(tok)
        _sync(dev)
        t3 = time.perf_counter()
    decode_s = t3 - t2
    steps = b * (new_tokens - 1)
    return ServeResult(
        tokens=torch.cat(out, dim=1).cpu(), prefill_s=t2 - t1,
        decode_s=decode_s,
        decode_tokens_per_s=steps / decode_s if steps else 0.0,
        peak_device_mem_mb=device_lib.peak_device_mem_mb(dev),
        cache_bytes=sum(t.numel() * t.element_size()
                        for t in tree_leaves(caches)),
        encode_s=t1 - t0 if enc_out is not None else 0.0)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--smoke", action="store_true",
                    help="the config's reduced smoke_variant")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--kv-int8", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="int8 KV cache (default: the arch's profile)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = device_lib.resolve(args.device)
    cfg = get_config(args.arch)
    prof = get_profile(args.arch)
    kv_int8 = prof.kv_int8 if args.kv_int8 is None else args.kv_int8
    if args.smoke:
        cfg = smoke_variant(cfg)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(cfg, gen)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=dev)
    # the stubbed front ends' inputs: frames or patch embeddings
    front = {}
    if cfg.frontend != "none":
        name = "frames" if cfg.is_enc_dec else "patch_embeds"
        front[name] = 0.1 * torch.randn(
            (args.batch, cfg.frontend_len, cfg.d_model), generator=gen,
            device=dev)
    res = serve_batch(cfg, params, prompts, args.tokens, device=dev,
                      dispatch=prof.moe_dispatch, quantized_cache=kv_int8,
                      **front)
    print(json.dumps({
        "arch": cfg.name, "device": str(dev),
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
        else "cpu",
        "params": param_count(params), "dtype": cfg.dtype,
        "moe_dispatch": prof.moe_dispatch if cfg.num_experts else None,
        "kv_int8": kv_int8, "cache_bytes": res.cache_bytes,
        "batch": args.batch, "prompt_len": args.prompt_len,
        "new_tokens": args.tokens, "frontend_len": cfg.frontend_len,
        "encode_s": res.encode_s, "prefill_s": res.prefill_s,
        "decode_s": res.decode_s,
        "decode_tokens_per_s": res.decode_tokens_per_s,
        "peak_device_mem_mb": res.peak_device_mem_mb,
        "first_tokens": res.tokens[:, :12].tolist()}))


if __name__ == "__main__":
    main()
