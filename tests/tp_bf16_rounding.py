"""How far a bf16 model's logits move when a (1, 2) mesh rounds in other
places than one device, beside how far one device's bf16 run sits from
the same weights in float32.

    PYTHONPATH=src:tests python tests/tp_bf16_rounding.py \\
        --arch mamba2-1.3b --layers 16 --seq 512

A script, not a test (~40 s on the CPU at full width): two gloo ranks
draw the model at full width with its depth cut (bf16, seed 11), keep
their blocks (`rules.local_shard`) and prefill one row of ``--seq``
tokens on the mesh program; rank 0 also prefills it on one device, in
bf16 and with every leaf in float32.  Prints the largest and rms
distances of the last position's logits: the mesh against one device,
one device against float32, the mesh against float32.
"""
import argparse
import os
import sys

import torch


def _rank(rank, world, out, arch, layers, seq, device):
    import torch
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    from repro_torch.configs import depth_cut, get_config, get_profile, replace
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps
    from repro_torch.models import init_params
    from repro_torch.models.model import prefill_last
    from repro_torch.sharding import rules
    from repro_torch.tree import tree_map
    mesh = mesh_lib.make_mesh((1, 2), device_type=device)
    cfg = replace(depth_cut(get_config(arch), layers), dtype="bfloat16")
    prof = get_profile(arch)
    gen = torch.Generator(device=device).manual_seed(11)
    full = init_params(cfg, gen)
    toks = torch.randint(0, cfg.vocab_size, (1, seq), generator=gen,
                         device=device)
    local = rules.local_shard(full, steps.param_specs(cfg, prof, mesh), mesh)
    tp = steps.mesh_program(mesh, prof)
    res = {}
    with torch.inference_mode():
        res["mesh"] = prefill_last(cfg, local, {"tokens": toks}, seq,
                                   tp=tp)[0].float().cpu()
        if rank == 0:
            res["one"] = prefill_last(cfg, full, {"tokens": toks},
                                      seq)[0].float().cpu()
            f32 = tree_map(lambda x: x.float(), full)
            res["f32"] = prefill_last(replace(cfg, dtype="float32"), f32,
                                      {"tokens": toks}, seq)[0].cpu()
    torch.save(res, f"{out}.{rank}.pt")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="mamba2-1.3b")
    ap.add_argument("--layers", type=int, default=16)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--out", default="build/tp_bf16_rounding")
    args = ap.parse_args(argv)
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as mesh_lib
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    mesh_lib.spawn_ranks(_rank, 2, (args.out, args.arch, args.layers,
                                    args.seq, args.device),
                         device_type=args.device, timeout_s=1800)
    parts = [torch.load(f"{args.out}.{r}.pt") for r in range(2)]
    v = get_config(args.arch).vocab_size
    mesh = torch.cat([p["mesh"] for p in parts], -1)[..., :v]
    one, f32 = parts[0]["one"][..., :v], parts[0]["f32"][..., :v]
    for name, a, b in (("mesh vs one device", mesh, one),
                       ("one device vs float32", one, f32),
                       ("mesh vs float32", mesh, f32)):
        d = a - b
        print(f"{name}: max {float(d.abs().max()):.4f}, rms "
              f"{float(d.square().mean().sqrt()):.4f} (logit rms "
              f"{float(b.square().mean().sqrt()):.4f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
