"""Batched serving demo on the PyTorch port: prefill a batch of prompts,
then decode tokens with ring-buffer KV caches (optionally int8-quantized),
on an arch's smoke variant with random weights.  The counterpart of
``examples/serve_batch.py``: an encoder-decoder arch (whisper-large-v3)
encodes 0.1 * normal frames once and hands the encoder's output to the
prefill and to every decode step.

    PYTHONPATH=src python examples/serve_batch_torch.py --arch gemma2-2b \
        --tokens 16 [--device cpu]

Runs on ``cuda`` unless ``--device cpu`` is asked for (no fallback).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import device as device_lib
from repro_torch.configs import get_config, smoke_variant
from repro_torch.models import decode_step, init_params
from repro_torch.models.model import prefill_last
from repro_torch.models.transformer import encode


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--kv-int8", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = device_lib.resolve(args.device)
    cfg = smoke_variant(get_config(args.arch))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen)
    max_len = args.prompt_len + args.tokens

    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=dev)
    batch = {"tokens": prompts}
    enc_out = None
    with torch.inference_mode():
        if cfg.frontend == "audio":
            frames = 0.1 * torch.randn(
                (args.batch, cfg.frontend_len, cfg.d_model), generator=gen,
                device=dev)
            enc_out = encode(cfg, params, frames, mode="prefill")
            batch["enc_out"] = enc_out

        _sync(dev)
        t0 = time.perf_counter()
        logits, caches = prefill_last(cfg, params, batch, max_len,
                                      quantized_cache=args.kv_int8)
        tok = logits.argmax(-1)[:, None]
        _sync(dev)
        print(f"prefill {args.batch}x{args.prompt_len} in "
              f"{time.perf_counter() - t0:.2f}s (kv cache: "
              f"{'int8' if args.kv_int8 else cfg.dtype}, device {dev})")

        out = [tok]
        t0 = time.perf_counter()
        for i in range(args.tokens - 1):
            logits, caches = decode_step(cfg, params, caches, tok,
                                         args.prompt_len + i, enc_out=enc_out)
            tok = logits[:, 0].argmax(-1)[:, None]
            out.append(tok)
        _sync(dev)
        dt = time.perf_counter() - t0
    seqs = torch.cat(out, dim=1).cpu()
    print(f"decoded {args.tokens} tokens/seq x {args.batch} seqs in "
          f"{dt:.2f}s ({args.tokens * args.batch / max(dt, 1e-9):.1f} tok/s)")
    print("greedy continuations (first 12 token ids per sequence):")
    for b in range(args.batch):
        print("  ", seqs[b, :12].tolist())


if __name__ == "__main__":
    main()
