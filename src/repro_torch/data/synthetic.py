"""Synthetic federated datasets with MNIST / CIFAR-10 geometry, and the
non-IID language-modelling token stream of the transformer FL run.

Counterpart of ``repro/data/synthetic.py``: class-conditional images (a
smooth random template per class + a smooth per-sample deformation +
noise), split across clients by a Dirichlet non-IID partition.
:func:`synthetic_lm_batches` is the port's copy of the token stream that
``examples/fl_transformer.py`` defines for itself.  Every draw
comes from an explicit ``torch.Generator``, so the values differ from the
JAX package's (its keys cannot be replayed here); the parity tests hand
both packages the same arrays instead.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class DatasetSpec:
    name: str = "mnist-like"
    img: int = 28
    channels: int = 1
    num_classes: int = 10
    template_scale: float = 2.0
    noise_scale: float = 0.6


MNIST_LIKE = DatasetSpec("mnist-like", 28, 1, 10, template_scale=0.6,
                         noise_scale=1.5)
CIFAR_LIKE = DatasetSpec("cifar-like", 32, 3, 10, template_scale=0.45,
                         noise_scale=2.2)


def smooth_from_coarse(coarse: torch.Tensor, img: int) -> torch.Tensor:
    """Bilinear upsampling of (..., 7, 7, ch) coarse noise to
    (..., img, img, ch), as ``jax.image.resize(..., "bilinear")``."""
    *lead, h, w, ch = coarse.shape
    x = coarse.reshape(-1, h, w, ch).permute(0, 3, 1, 2)
    y = F.interpolate(x, size=(img, img), mode="bilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 1).reshape(*lead, img, img, ch)


def _smooth(gen: torch.Generator, shape: Tuple[int, ...],
            img: int) -> torch.Tensor:
    """Low-frequency random field: upsampled coarse noise."""
    coarse = torch.randn(shape[:-3] + (7, 7, shape[-1]), generator=gen,
                         device=gen.device)
    return smooth_from_coarse(coarse, img)


def make_dataset(gen: torch.Generator, spec: DatasetSpec, n: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(images (n, img, img, C) f32, labels (n,) int64) on gen's device."""
    dev = gen.device
    shape = (spec.img, spec.img, spec.channels)
    templates = _smooth(gen, (spec.num_classes,) + shape,
                        spec.img) * spec.template_scale
    labels = torch.randint(0, spec.num_classes, (n,), generator=gen,
                           device=dev)
    deform = _smooth(gen, (n,) + shape, spec.img) * 0.5
    noise = torch.randn((n,) + shape, generator=gen,
                        device=dev) * spec.noise_scale
    return templates[labels] + deform + noise, labels


def make_split(gen: torch.Generator, spec: DatasetSpec, n_train: int,
               n_test: int):
    """One generation (shared class templates), split into train/test."""
    x, y = make_dataset(gen, spec, n_train + n_test)
    return (x[:n_train], y[:n_train]), (x[n_train:], y[n_train:])


def _gamma(gen: torch.Generator, alpha: float,
           shape: Tuple[int, ...]) -> torch.Tensor:
    """Gamma(alpha, 1) draws by Marsaglia-Tsang rejection, with the
    ``U**(1/alpha)`` boost for alpha < 1 (torch's own gamma sampler takes
    no generator)."""
    dev = gen.device
    a = alpha + 1.0 if alpha < 1.0 else alpha
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    out = torch.empty(shape, device=dev)
    todo = torch.ones(shape, dtype=torch.bool, device=dev)
    while bool(todo.any()):             # set-up only: host syncs are fine
        x = torch.randn(shape, generator=gen, device=dev)
        u = torch.rand(shape, generator=gen, device=dev)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(v.clamp_min(1e-30)))
        take = todo & ok
        out = torch.where(take, d * v, out)
        todo = todo & ~ok
    if alpha < 1.0:
        u = torch.rand(shape, generator=gen, device=dev)
        out = out * u ** (1.0 / alpha)
    return out


def dirichlet_partition(gen: torch.Generator, labels: torch.Tensor,
                        num_clients: int, alpha: float = 0.5,
                        samples_per_client: int = 128,
                        num_classes: int = 10) -> torch.Tensor:
    """Non-IID split: per-client class mixture ~ Dirichlet(alpha); each
    slot draws a class from the mixture, then a random example of that
    class (with replacement, so shapes stay static).  Returns
    (num_clients, samples_per_client) int64 indices into ``labels``."""
    g = _gamma(gen, alpha, (num_clients, num_classes)).clamp_min(1e-30)
    mix = g / g.sum(dim=1, keepdim=True)
    cls = torch.multinomial(mix, samples_per_client, replacement=True,
                            generator=gen)                       # (C, S)
    order = torch.argsort(labels, stable=True)
    sorted_labels = labels[order]
    classes = torch.arange(num_classes, device=labels.device)
    starts = torch.searchsorted(sorted_labels, classes)
    counts = torch.searchsorted(sorted_labels, classes, right=True) - starts
    offs = torch.rand((num_clients, samples_per_client), generator=gen,
                      device=gen.device)
    idx_in_class = (offs * counts[cls]).long()
    # a class with no examples indexes past the end; clamp as JAX's gather
    return order[(starts[cls] + idx_in_class).clamp_max(labels.numel() - 1)]


def client_batches(images: torch.Tensor, labels: torch.Tensor,
                   client_idx: torch.Tensor, picks: torch.Tensor):
    """One minibatch per client from the (C, B) slot ``picks``:
    ((C, B, H, W, ch), (C, B))."""
    flat = torch.gather(client_idx, 1, picks.long())
    return images[flat], labels[flat]


def synthetic_lm_batches(gen: torch.Generator, n_clients: int, seq: int,
                         batch: int, band: int = 256) -> torch.Tensor:
    """Per-client token streams with client-specific skew (the non-IID
    structure FL must average over): each client draws a mixture over a
    shared ``band`` of token ids from Dirichlet(0.3) and its tokens i.i.d.
    from that mixture.  Returns (n_clients, batch, seq + 1) int32 on the
    generator's device."""
    g = _gamma(gen, 0.3, (n_clients, band)).clamp_min(1e-30)
    probs = g / g.sum(dim=1, keepdim=True)
    toks = torch.multinomial(probs, batch * (seq + 1), replacement=True,
                             generator=gen)
    return toks.reshape(n_clients, batch, seq + 1).to(torch.int32)
