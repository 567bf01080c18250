"""FedHC on a client mesh of the PyTorch/CUDA port: one process a rank,
each holding its own rows of the client stack.

    # four ranks on the CPU (gloo)
    PYTHONPATH=src torchrun --nproc-per-node 4 examples/mesh_torch.py \
        --device cpu
    # one rank a card (NCCL)
    PYTHONPATH=src torchrun --nproc-per-node 8 examples/mesh_torch.py

Every rank runs the same scenario with ``ExecSpec(mesh_devices=0)`` (the
whole process group) and gets the same ``RunResult``; rank 0 prints it
beside the single-device run's.  It imports nothing of JAX.
"""
import argparse
import os

import torch
import torch.distributed as dist

from repro_torch import api
from repro_torch.api import DataSpec, ExecSpec, FleetSpec, Scenario, TrainSpec
from repro_torch.launch import mesh as mesh_lib


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default, NCCL) or cpu (gloo)")
    ap.add_argument("--method", default="fedhc")
    ap.add_argument("--num-clients", type=int, default=32)
    args = ap.parse_args(argv)
    if args.device == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    else:
        torch.set_num_threads(1)
    mesh_lib.init_process_group(args.device)       # torchrun's env:// store
    try:
        sc = Scenario(method=args.method,
                      data=DataSpec(samples_per_client=32, eval_size=256),
                      fleet=FleetSpec(num_clients=args.num_clients,
                                      num_clusters=3),
                      train=TrainSpec(rounds=8, rounds_per_global=4,
                                      eval_every=4, local_steps=1,
                                      batch_size=16),
                      exec=ExecSpec(mesh_devices=0))
        res = api.run(sc, device=args.device)
        if dist.get_rank() == 0:
            one = api.run(sc.replace(exec=ExecSpec()), device=args.device)
            print(f"mesh {res.mesh_shape}: acc {res.acc.tolist()} "
                  f"loss {res.loss.tolist()}")
            print(f"one device:   acc {one.acc.tolist()} "
                  f"loss {one.loss.tolist()}")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
