"""Model FLOPs of LeNet-5 from its shapes: multiply-adds of the two
valid convolutions and the three dense layers, two FLOPs each.  A
training sample-step counts three forwards' worth (forward, input
gradient, weight gradient); no elementwise work is counted."""
from __future__ import annotations

from typing import Any, Dict


def forward_flops(ds: Dict[str, Any], model: Dict[str, Any]) -> int:
    """FLOPs of one sample's forward pass."""
    kk = model["kernel"]
    c1, c2 = model["conv"]
    d1, d2 = model["dense"]
    img, ch, k = ds["img"], ds["channels"], ds["num_classes"]
    o1 = img - kk + 1
    p1 = o1 // 2
    o2 = p1 - kk + 1
    p2 = o2 // 2
    macs = (o1 * o1 * c1 * kk * kk * ch
            + o2 * o2 * c2 * kk * kk * c1
            + p2 * p2 * c2 * d1 + d1 * d2 + d2 * k)
    return 2 * macs


def train_flops(ds, model) -> int:
    """FLOPs of one sample through forward and backward."""
    return 3 * forward_flops(ds, model)


def params(ds, model) -> int:
    kk = model["kernel"]
    c1, c2 = model["conv"]
    d1, d2 = model["dense"]
    img, ch, k = ds["img"], ds["channels"], ds["num_classes"]
    p2 = ((img - kk + 1) // 2 - kk + 1) // 2
    return (kk * kk * ch * c1 + c1 + kk * kk * c1 * c2 + c2
            + p2 * p2 * c2 * d1 + d1 + d1 * d2 + d2 + d2 * k + k)


def run_flops(config: Dict[str, Any], rounds: int, reclusters: int,
              evals: int, clients: int) -> int:
    """Model FLOPs of a run: ``clients`` train ``local_steps`` steps of
    ``batch_size`` every round, each re-cluster's MAML hand-off takes
    three gradients of every client's batch (inner step, meta-gradient,
    the inherited model's inner step), each evaluation one forward of
    ``eval_size`` samples."""
    ds, model, fl = config["dataset"], config["model"], config["fl"]
    tr = train_flops(ds, model)
    batch = clients * fl["batch_size"]
    return (rounds * fl["local_steps"] * batch * tr
            + reclusters * 3 * batch * tr
            + evals * fl["eval_size"] * forward_flops(ds, model))
