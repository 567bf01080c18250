"""FL training of a transformer on one device: C clients stacked on the
card, FedHC rounds of local SGD and two-stage aggregation.

    python -m repro_torch.launch.train --arch gemma2-2b [--shape train_4k] \
        [--rounds 3] [--clusters 2] [--rounds-per-global 2] [--lr 0.01] \
        [--clients 4] [--global-batch 16] [--seed 0] [--device cpu] [--smoke]
        [--layers N]

The port's counterpart of ``repro/launch/train.py``.  The reference builds
the production mesh and, on the CPU, stops after a dry run ("requires the
TPU pod"); the port runs the loop on the card.  It derives the cluster
layout from the orbital simulator (the port's k-means over the clients'
positions -> ``balanced_clusters`` -> static groups), builds the
one-device train step (`launch/steps.py`) with the hand-written stage-1
kernel on (``use_kernels``), replicates one random model (``--seed``) over
the clients, and each round draws every client's batch from the
non-IID token stream (`data/synthetic.synthetic_lm_batches`).  Prints one
JSON line: s a round, tokens/s, mean client CE a round, peak device
memory, and the time of one stage-1 over the final stack, taken after the
rounds.

The defaults are the one-card run: 4 clients, 2 clusters, 3 rounds,
stage-2 every 2, a global batch of 16 (the reference's defaults are 100
rounds, 4 clusters, stage-2 every 5, and the shape's batch of 256).  The
front ends train on 0.1 * normal frames (whisper-large-v3) or patch
embeddings (pixtral-12b, whose text then takes the sequence less its
patches), drawn each round.
``--mesh DxM`` trains on a ("data", "model") mesh of D x M spawned ranks,
the clients the mesh lays out (`train_rank`), any of the ten archs.
``--smoke`` takes the config's ``smoke_variant`` and a 64-token sequence,
as ``launch/serve.py`` does; ``--layers`` cuts the depth
(``configs.depth_cut``), as a MoE client stack needs on one card
(mixtral-8x22b fits at ``--clients 2 --clusters 1 --layers 2``).
``--dry-run`` counts the round step at the arguments given on fake
tensors (`launch/dryrun.py`: nothing is run or allocated on a device),
prints the per-device peak, the memory analysis
and the flops and bytes accessed, as the reference's ``--dry-run``
prints its compiled step's, and exits.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import statistics
import time
from typing import List, NamedTuple, Optional, Tuple

import torch

from repro_torch import device as device_lib
from repro_torch.configs import (SHAPES, depth_cut, get_config, get_profile,
                                 smoke_variant)
from repro_torch.core import aggregation as agg
from repro_torch.core import aggregation_spmd as spmd
from repro_torch.core.clustering import balanced_clusters, kmeans
from repro_torch.data.synthetic import synthetic_lm_batches
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.steps import build_train_step
from repro_torch.models import init_params
from repro_torch.orbits.constellation import Constellation
from repro_torch.tree import tree_leaves

SMOKE_SEQ = 64


class RoundRecord(NamedTuple):
    round: int
    s: float                  # wall time of the round, host clock, synced
    tokens_per_s: float       # global batch x sequence / s
    ce: float                 # mean client loss (CE) of the round
    did_global: bool          # stage-2 ran at the end of the round


class TrainResult(NamedTuple):
    rounds: List[RoundRecord]
    peak_device_mem_mb: Optional[float]
    clusters: Tuple[Tuple[int, ...], ...]
    meta: dict
    stack: dict               # the final (C, ...) client stack


def orbital_clusters(n_clients: int, k: int, seed: int = 0
                     ) -> Tuple[Tuple[int, ...], ...]:
    """Static cluster groups from geometry, as the reference's launcher
    derives them: the clients are the first satellites of a small Walker
    constellation at t = 0, k-means over their positions (the initial
    centroids a seeded permutation), then ``balanced_clusters`` into
    equal groups.  ``k`` drops to the largest divisor of ``n_clients``."""
    k = min(k, n_clients)
    while n_clients % k:
        k -= 1
    planes = max(2, n_clients // 8)
    con = Constellation(num_planes=planes,
                        sats_per_plane=max(1, n_clients // planes))
    pos = con.positions(0.0)[:n_clients]
    gen = torch.Generator().manual_seed(seed)
    res = kmeans(pos, k, torch.randperm(n_clients, generator=gen)[:k])
    groups = balanced_clusters(res.assignment, k, n_clients // k)
    return tuple(tuple(g) for g in groups.tolist())


def init_model(cfg, seed: int, device) -> dict:
    """The random model from ``seed`` that every client starts from."""
    return init_params(cfg, torch.Generator(device=device).manual_seed(seed))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def stage1_ms(stack, clusters, *, use_kernels: bool, reps: int = 3) -> float:
    """Median time of one stage-1 (``cluster_aggregate``) over ``stack``:
    CUDA events on the card, the host clock on the CPU."""
    leaf = tree_leaves(stack)[0]
    dev, n = leaf.device, leaf.shape[0]
    a = spmd.clusters_to_assignment(clusters, n, device=dev)
    k = len(clusters)
    w = agg.cluster_weights(torch.ones(n, device=dev),
                            torch.ones(n, device=dev), a, k)
    times = []
    for _ in range(reps):
        _sync(dev)
        if dev.type == "cuda":
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            out = agg.cluster_aggregate(stack, w, a, k,
                                        use_kernels=use_kernels)
            t1.record()
            t1.synchronize()
            times.append(t0.elapsed_time(t1))
        else:
            t = time.perf_counter()
            out = agg.cluster_aggregate(stack, w, a, k,
                                        use_kernels=use_kernels)
            times.append((time.perf_counter() - t) * 1e3)
        del out
    return statistics.median(times)


def train(arch: str = "gemma2-2b", *, shape: str = "train_4k",
          rounds: int = 3, clusters: int = 2, rounds_per_global: int = 2,
          lr: float = 0.01, clients: int = 4,
          global_batch: Optional[int] = 16, seed: int = 0, device=None,
          smoke: bool = False, use_kernels: bool = True,
          layers: Optional[int] = None) -> TrainResult:
    """Run ``rounds`` FedHC rounds of ``arch`` on one device; see the
    module docstring.  ``layers`` cuts the depth (``configs.depth_cut``:
    an encoder-decoder's encoder too)."""
    dev = device_lib.resolve(device)
    cfg = get_config(arch)
    if smoke:
        cfg = smoke_variant(cfg)
    if layers:
        cfg = depth_cut(cfg, layers)
    prof = get_profile(arch)
    shp = SHAPES[shape]
    if shp.mode != "train":
        raise ValueError(f"{shape} is a {shp.mode} shape; use "
                         f"repro_torch.launch.serve for serving")
    shp = dataclasses.replace(
        shp, seq_len=SMOKE_SEQ if smoke else shp.seq_len,
        global_batch=global_batch or shp.global_batch)
    groups = orbital_clusters(clients, clusters, seed)
    bundle = build_train_step(arch, shp, None, num_clusters=len(groups),
                              lr=lr, rounds_per_global=rounds_per_global,
                              num_clients=clients, clusters=groups,
                              use_kernels=use_kernels, cfg=cfg, profile=prof)
    cfg = dataclasses.replace(cfg, dtype=prof.param_dtype)
    stack = agg.broadcast_global(init_model(cfg, seed, dev), clients)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    tokens = shp.global_batch * shp.seq_len
    pcb = bundle.meta["pcb"]
    # a vision prompt's patches take frontend_len of the sequence
    text = shp.seq_len - (cfg.frontend_len if cfg.frontend == "vision" else 0)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    records = []
    for r in range(rounds):
        # a round's (C, pcb, seq) batch, as examples/fl_transformer.py
        # builds it from the stream
        t = synthetic_lm_batches(gen, clients, text, pcb)
        batch = {"tokens": t[..., :-1], "labels": t[..., 1:]}
        if cfg.frontend != "none":
            # the stubbed front end's input: 0.1 * normal frames (enc-dec)
            # or patch embeddings (vision)
            batch["frames" if cfg.is_enc_dec else "patch_embeds"] = (
                0.1 * torch.randn((clients, pcb, cfg.frontend_len,
                                   cfg.d_model), generator=gen, device=dev))
        _sync(dev)
        t0 = time.perf_counter()
        stack, loss = bundle.fn(stack, batch, r)
        ce = float(loss)
        _sync(dev)
        s = time.perf_counter() - t0
        records.append(RoundRecord(r, s, tokens / s, ce,
                                   (r + 1) % rounds_per_global == 0))
    peak = device_lib.peak_device_mem_mb(dev)
    meta = dict(bundle.meta, arch=cfg.name, vocab=cfg.vocab_size,
        params=sum(x[0].numel() for x in tree_leaves(stack)),
        seq=shp.seq_len, global_batch=shp.global_batch,
        rounds_per_global=rounds_per_global, lr=lr, seed=seed,
        device=str(dev))
    return TrainResult(records, peak, groups, meta, stack)


def train_rank(rank: int, world: int, opts: dict) -> None:
    """One rank of ``--mesh DxM`` (`launch/mesh.spawn_ranks`): the mesh
    form of the train step (`launch/steps.py`) with one client per
    client-axis index of the ("data", "model") mesh, tensor parallelism
    over "model" inside a client and, for a pod-client arch, FSDP and the
    batch over "data".  Every client starts from the model one device
    draws from ``--seed`` (the ranks draw it one after another and keep
    their blocks) and each round's batch is one device's draw, of which
    the rank takes its client's rows (its block of them under FSDP).
    Rank 0 prints a JSON line: s a round, the mean client CE, peak memory,
    the bytes the collectives moved a round."""
    from repro_torch.launch import steps
    from repro_torch.sharding import parallel as P
    from repro_torch.tree import tree_map
    dev = device_lib.resolve(opts["device"])
    d, m = mesh_lib.parse_mesh(opts["mesh"])
    mesh = mesh_lib.make_mesh((d, m), device_type=dev.type)
    cfg = get_config(opts["arch"])
    if opts["smoke"]:
        cfg = smoke_variant(cfg)
    if opts.get("layers"):
        cfg = depth_cut(cfg, opts["layers"])
    prof = get_profile(opts["arch"])
    shp = dataclasses.replace(
        SHAPES[opts["shape"]],
        seq_len=SMOKE_SEQ if opts["smoke"] else SHAPES[opts["shape"]].seq_len,
        global_batch=opts["global_batch"] or SHAPES[opts["shape"]]
        .global_batch)
    n_clients = mesh_lib.num_clients_for(mesh, prof.client_axis)
    c_axes = mesh_lib.client_axes_for(mesh, prof.client_axis)
    groups = orbital_clusters(n_clients, opts["clusters"], opts["seed"])
    rpg = opts["rounds_per_global"]
    bundle = build_train_step(opts["arch"], shp, mesh,
                              num_clusters=len(groups), lr=opts["lr"],
                              rounds_per_global=rpg, clusters=groups,
                              cfg=cfg, profile=prof)
    cfg = dataclasses.replace(cfg, dtype=prof.param_dtype)
    specs = steps.param_specs(cfg, prof, mesh)
    local, _ = mesh_lib.local_blocks(
        lambda: init_model(cfg, opts["seed"], dev), specs, mesh)
    stack = tree_map(lambda x: x[None], local)
    del local
    table = mesh_lib.client_rank_table(mesh, c_axes)
    client = next(c for c, row in enumerate(table) if rank in row)
    pcb, rows = bundle.meta["pcb"], bundle.meta["rank_rows"]
    lo = (mesh.get_local_rank("data") * rows if rows != pcb else 0)
    gen = torch.Generator(device=dev).manual_seed(opts["seed"] + 1)
    text = shp.seq_len - (cfg.frontend_len if cfg.frontend == "vision"
                          else 0)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    records = []
    for r in range(opts["rounds"]):
        t = synthetic_lm_batches(gen, n_clients, text, pcb)
        t = t[client:client + 1, lo:lo + rows]
        batch = {"tokens": t[..., :-1], "labels": t[..., 1:]}
        if cfg.frontend != "none":           # as one device draws them
            front = 0.1 * torch.randn((n_clients, pcb, cfg.frontend_len,
                                       cfg.d_model), generator=gen,
                                      device=dev)
            batch["frames" if cfg.is_enc_dec else "patch_embeds"] = \
                front[client:client + 1, lo:lo + rows]
        P.reset_traffic()
        _sync(dev)
        t0 = time.perf_counter()
        stack, loss = bundle.fn(stack, batch, r)
        ce = float(loss)
        _sync(dev)
        s = time.perf_counter() - t0
        records.append(dict(round=r, s=s, ce=ce,
                            did_global=(r + 1) % rpg == 0,
                            collective_bytes=P.traffic()))
    line = {"arch": cfg.name, "device": str(dev), "mesh": {"data": d,
                                                          "model": m},
            "clients": n_clients, "clusters": groups, "pcb": pcb,
            "rank_rows": rows, "rank_accum": bundle.meta["rank_accum"],
            "rounds": records,
            "peak_device_mem_mb": device_lib.peak_device_mem_mb(dev)}
    if rank == 0:
        print(json.dumps(line), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--clusters", type=int, default=2)
    ap.add_argument("--rounds-per-global", type=int, default=2)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help="the config's reduced smoke_variant, 64 tokens")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--dry-run", action="store_true",
                    help="count the round step on fake tensors, print the "
                         "analyses, exit")
    ap.add_argument("--mesh", default=None,
                    help="DxM: train on a (data, model) mesh of D x M "
                         "spawned ranks (the mesh sets the clients)")
    args = ap.parse_args(argv)
    if args.dry_run:
        from repro_torch.launch import dryrun
        rec = dryrun.run_one(
            args.arch, args.shape, "one", smoke=args.smoke,
            clients=args.clients, clusters=args.clusters,
            global_batch=args.global_batch,
            rounds_per_global=args.rounds_per_global, num_layers=args.layers,
            seq_len=SMOKE_SEQ if args.smoke else SHAPES[args.shape].seq_len)
        dryrun.print_analyses(rec)
        return
    if args.mesh:
        d, m = mesh_lib.parse_mesh(args.mesh)
        mesh_lib.spawn_ranks(train_rank, d * m, (vars(args),),
                             device_type=device_lib.resolve(args.device).type)
        return
    res = train(args.arch, shape=args.shape, rounds=args.rounds,
                clusters=args.clusters,
                rounds_per_global=args.rounds_per_global, lr=args.lr,
                clients=args.clients, global_batch=args.global_batch,
                seed=args.seed, device=args.device, smoke=args.smoke,
                layers=args.layers)
    dev = torch.device(res.meta["device"])
    ms = stage1_ms(res.stack, res.clusters, use_kernels=True)
    print(json.dumps({
        **{k: res.meta[k] for k in ("arch", "device", "params", "dtype",
                                    "seq", "global_batch", "pcb", "accum",
                                    "micro", "lr", "rounds_per_global")},
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
        else "cpu",
        "clients": res.meta["n_clients"], "clusters": res.clusters,
        "rounds": [r._asdict() for r in res.rounds],
        "s_per_round": statistics.mean(r.s for r in res.rounds),
        "tokens_per_s": statistics.mean(r.tokens_per_s for r in res.rounds),
        "ln_vocab": math.log(res.meta["vocab"]),
        "stage1_ms": ms,
        "peak_device_mem_mb": res.peak_device_mem_mb}))


if __name__ == "__main__":
    main()
