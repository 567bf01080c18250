"""End-to-end driver on the PyTorch/CUDA port: hierarchical clustered FL
training of a transformer language model.

    PYTHONPATH=src python examples/fl_transformer_torch.py \
        --d-model 640 --layers 14 --steps 300          # ~110M params
    PYTHONPATH=src python examples/fl_transformer_torch.py --small \
        --device cpu                                   # CPU-quick

The flow of ``examples/fl_transformer.py`` on ``repro_torch``: each FL
client (satellite) holds its own copy of the model and a non-IID shard of
a synthetic language-modelling task; every round runs one local Adam step
per client, then the FedHC two-stage aggregation (loss-weighted
intra-cluster, Eq. 12; ground-station aggregation every m rounds, Eq. 5)
through ``core.aggregation.hierarchical_round``.  The clients' gradients
are taken one client at a time and stacked, and one Adam update moves
every client (the optimizer is elementwise over the (C, ...) stack).
Runs on ``cuda`` unless ``--device cpu`` is asked for; the stage-1
aggregation goes through the hand-written kernel on the card.  It imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import device as device_lib
from repro_torch.configs.base import ModelConfig
from repro_torch.core import aggregation as agg
from repro_torch.data.synthetic import synthetic_lm_batches
from repro_torch.models import init_params, loss_fn, param_count
from repro_torch.optim import adam_init, adam_update
from repro_torch.tree import tree_leaves, tree_unflatten


def make_cfg(d_model: int, layers: int) -> ModelConfig:
    return ModelConfig(
        name="fl-lm", family="dense", num_layers=layers, d_model=d_model,
        num_heads=max(4, d_model // 64), num_kv_heads=max(2, d_model // 128),
        head_dim=64, d_ff=4 * d_model, vocab_size=16384, dtype="float32",
        citation="example")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--d-model", type=int, default=640)
    ap.add_argument("--layers", type=int, default=14)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--clusters", type=int, default=2)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--rounds-per-global", type=int, default=5)
    ap.add_argument("--small", action="store_true",
                    help="~6M params, quick CPU demo")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.small:
        args.d_model, args.layers, args.steps = 192, 4, 60
    dev = device_lib.resolve(args.device)

    cfg = make_cfg(args.d_model, args.layers)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen)
    n_params = param_count(params)
    print(f"model: {args.layers}L d{args.d_model} = {n_params/1e6:.1f}M params"
          f" x {args.clients} clients")

    stack = agg.broadcast_global(params, args.clients)
    opt = adam_init(stack)
    assignment = torch.tensor([i % args.clusters
                               for i in range(args.clients)],
                              dtype=torch.int32, device=dev)
    sizes = torch.ones(args.clients, device=dev)

    def round_step(stack, opt, do_global):
        toks = synthetic_lm_batches(gen, args.clients, args.seq, args.batch)
        leaves = tree_leaves(stack)
        grads, losses = [], []
        for c in range(args.clients):
            ps = [x[c].detach().requires_grad_(True) for x in leaves]
            t = toks[c]
            loss, _ = loss_fn(cfg, tree_unflatten(stack, ps),
                              {"tokens": t[:, :-1], "labels": t[:, 1:]})
            grads.append(torch.autograd.grad(loss, ps))
            losses.append(loss.detach())
        g = tree_unflatten(stack, [torch.stack(gs) for gs in zip(*grads)])
        stack, opt = adam_update(stack, g, opt, lr=args.lr)
        losses = torch.stack(losses)
        stack = agg.hierarchical_round(stack, losses, sizes, assignment,
                                       args.clusters, do_global=do_global,
                                       use_kernels=True)
        return stack, opt, losses.mean()

    t0 = time.time()
    for r in range(args.steps):
        do_global = (r + 1) % args.rounds_per_global == 0
        stack, opt, loss = round_step(stack, opt, do_global)
        if (r + 1) % max(1, args.steps // 15) == 0 or r == 0:
            print(f"round {r+1:4d}  mean client CE {float(loss):.4f}  "
                  f"({time.time()-t0:.0f}s)", flush=True)
    print(f"done: {args.steps} rounds in {time.time()-t0:.0f}s; "
          f"final loss {float(loss):.4f}")


if __name__ == "__main__":
    main()
