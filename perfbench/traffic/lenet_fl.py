"""Inputs of a FedHC run over LeNet clients, made from the seed on the
device: the MNIST-like synthetic split (a smooth random template per
class, a smooth per-sample deformation and noise), its Dirichlet
non-IID partition over the satellites, the initial LeNet weights, each
run's minibatch picks, and the fleet's CPU frequencies and k-means
starting indices.

The data and picks follow ``--seed``.  The fleet (frequencies, k-means
starts) follows the configuration's ``fleet_seed``: it is the
deployment, not the traffic, and with it every seed does the same
re-clustering work.  The synthetic split is a copy of the program's
``data/synthetic.py`` generator, so the benchmark owns its inputs.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from pb import seeds


def _smooth(gen, n: int, img: int, ch: int) -> torch.Tensor:
    """(n, img, img, ch) low-frequency fields: 7x7 noise upsampled."""
    coarse = torch.randn((n, ch, 7, 7), generator=gen, device=gen.device)
    up = F.interpolate(coarse, size=(img, img), mode="bilinear",
                       align_corners=False)
    return up.permute(0, 2, 3, 1).contiguous()


def make_split(gen, ds: Dict[str, Any], n: int):
    img, ch, k = ds["img"], ds["channels"], ds["num_classes"]
    templates = _smooth(gen, k, img, ch) * ds["template_scale"]
    labels = torch.randint(0, k, (n,), generator=gen, device=gen.device)
    x = templates[labels]
    x += _smooth(gen, n, img, ch) * 0.5
    x += torch.randn(x.shape, generator=gen, device=gen.device) \
        * ds["noise_scale"]
    return x, labels


def _gamma(gen, alpha: float, shape) -> torch.Tensor:
    """Gamma(alpha, 1) by Marsaglia-Tsang rejection (the boost for
    alpha < 1); set-up only, so its host reads are fine."""
    dev = gen.device
    a = alpha + 1.0 if alpha < 1.0 else alpha
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    out = torch.empty(shape, device=dev)
    todo = torch.ones(shape, dtype=torch.bool, device=dev)
    while bool(todo.any()):
        x = torch.randn(shape, generator=gen, device=dev)
        u = torch.rand(shape, generator=gen, device=dev)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(v.clamp_min(1e-30)))
        out = torch.where(todo & ok, d * v, out)
        todo = todo & ~ok
    if alpha < 1.0:
        out = out * torch.rand(shape, generator=gen, device=dev) ** (1 / alpha)
    return out


def partition(gen, labels, clients: int, per_client: int, alpha: float,
              classes: int) -> torch.Tensor:
    """(clients, per_client) indices into ``labels``: each client's class
    mixture ~ Dirichlet(alpha), each slot a class from it, then a random
    example of that class."""
    g = _gamma(gen, alpha, (clients, classes)).clamp_min(1e-30)
    mix = g / g.sum(1, keepdim=True)
    cls = torch.multinomial(mix, per_client, replacement=True, generator=gen)
    order = torch.argsort(labels, stable=True)
    sorted_labels = labels[order]
    ids = torch.arange(classes, device=labels.device)
    starts = torch.searchsorted(sorted_labels, ids)
    counts = torch.searchsorted(sorted_labels, ids, right=True) - starts
    offs = torch.rand((clients, per_client), generator=gen,
                      device=gen.device)
    pick = (offs * counts[cls]).long()
    return order[(starts[cls] + pick).clamp_max(labels.numel() - 1)]


def lenet_init(gen, ds: Dict[str, Any], model: Dict[str, Any]
               ) -> Dict[str, Dict[str, torch.Tensor]]:
    """LeNet-5 weights in the NHWC layout: (kh, kw, cin, cout) convs,
    (in, out) dense layers, N(0, 1/fan_in), zero biases."""
    dev = gen.device
    kk, c1, c2 = model["kernel"], model["conv"][0], model["conv"][1]
    img, ch = ds["img"], ds["channels"]
    s2 = ((img - kk + 1) // 2 - kk + 1) // 2
    flat = c2 * s2 * s2
    d1, d2 = model["dense"]
    k = ds["num_classes"]

    def normal(shape, fan):
        return torch.randn(shape, generator=gen, device=dev) / math.sqrt(fan)

    def zeros(n):
        return torch.zeros((n,), device=dev)

    return {
        "c1": {"w": normal((kk, kk, ch, c1), kk * kk * ch), "b": zeros(c1)},
        "c2": {"w": normal((kk, kk, c1, c2), kk * kk * c1), "b": zeros(c2)},
        "f1": {"w": normal((flat, d1), flat), "b": zeros(d1)},
        "f2": {"w": normal((d1, d2), d1), "b": zeros(d2)},
        "f3": {"w": normal((d2, k), d2), "b": zeros(k)},
    }


def make_inputs(config: Dict[str, Any], seed: int, device) -> Dict[str, Any]:
    """Everything a run is set up from, on ``device``."""
    ds, fl, fleet = config["dataset"], config["fl"], config["fleet"]
    c = fleet["num_clients"]
    n_train = c * fl["samples_per_client"]
    gen = seeds.generator(device, seed, "lenet_fl/data")
    x, y = make_split(gen, ds, n_train + fl["eval_size"])
    client_idx = partition(seeds.generator(device, seed, "lenet_fl/part"),
                           y[:n_train], c, fl["samples_per_client"],
                           fl["dirichlet_alpha"], ds["num_classes"])
    w0 = lenet_init(seeds.generator(device, seed, "lenet_fl/model"), ds,
                    config["model"])
    fleet_gen = seeds.generator(device, config["fleet_seed"], "lenet_fl/freq")
    cp = config["compute"]
    freqs = cp["min_freq_hz"] + torch.rand(
        (c,), generator=fleet_gen, device=device) * (
            cp["max_freq_hz"] - cp["min_freq_hz"])
    init_gen = seeds.generator(device, config["fleet_seed"],
                               "lenet_fl/kmeans0")
    k = fleet["num_clusters"]
    init_idx = torch.randperm(c, generator=init_gen, device=device)[:k]
    return {"images": x[:n_train], "labels": y[:n_train],
            "test_x": x[n_train:], "test_y": y[n_train:],
            "client_idx": client_idx, "w0": w0, "freqs": freqs,
            "init_idx": init_idx}


def recluster_starts(config: Dict[str, Any], rounds: int, device
                     ) -> torch.Tensor:
    """(rounds, K) k-means starting indices of the re-clusters, from the
    fleet seed: the same for every run and seed."""
    c, k = config["fleet"]["num_clients"], config["fleet"]["num_clusters"]
    out = torch.empty((rounds, k), dtype=torch.long, device=device)
    for r in range(rounds):
        g = seeds.generator(device, config["fleet_seed"],
                            "lenet_fl/kmeans", r)
        out[r] = torch.randperm(c, generator=g, device=device)[:k]
    return out


def batch_picks(config: Dict[str, Any], rounds: int, seed: int, run: int,
                device) -> torch.Tensor:
    """(rounds, C, B) minibatch slots of run ``run``: one draw a run."""
    fl, c = config["fl"], config["fleet"]["num_clients"]
    g = seeds.generator(device, seed, "lenet_fl/picks", run)
    return torch.randint(0, fl["samples_per_client"],
                         (rounds, c, fl["batch_size"]), generator=g,
                         device=device)
