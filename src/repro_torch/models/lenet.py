"""LeNet-5-style CNN, the model the FedHC paper trains (§IV-A).

Counterpart of ``repro/models/lenet.py`` with the same layout, so weights
carry across without a transpose: NHWC images, ``(kh, kw, cin, cout)``
conv weights, ``(in, out)`` dense weights, and the same im2col column
order ``(i, j, cin)``.  Parameters are a nested dict of tensors.

Every function takes an optional leading client dimension: parameters of
shape ``(C, *leaf)`` with images ``(C, B, H, W, ch)`` and labels ``(C, B)``
run C independent models at once (the reference's ``vmap`` over clients,
written out), the convolutions becoming batched GEMMs.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_map

Params = Dict[str, Dict[str, torch.Tensor]]


def init_lenet(gen: torch.Generator, in_ch: int = 1, img: int = 28,
               num_classes: int = 10, *, device: torch.device) -> Params:
    """Same shapes and scales as the reference; the draws come from
    ``gen`` (a generator on ``device``), so values differ from JAX's."""
    s1 = (img - 4) // 2                 # after conv1 + pool
    s2 = (s1 - 4) // 2                  # after conv2 + pool
    flat = 16 * s2 * s2

    def normal(shape, fan):
        return torch.randn(shape, generator=gen, device=device) / math.sqrt(fan)

    def zeros(n):
        return torch.zeros((n,), device=device)

    return {
        "c1": {"w": normal((5, 5, in_ch, 6), 25 * in_ch), "b": zeros(6)},
        "c2": {"w": normal((5, 5, 6, 16), 150), "b": zeros(16)},
        "f1": {"w": normal((flat, 120), flat), "b": zeros(120)},
        "f2": {"w": normal((120, 84), 120), "b": zeros(84)},
        "f3": {"w": normal((84, num_classes), 84), "b": zeros(num_classes)},
    }


def from_numpy(tree: Any, device: torch.device) -> Any:
    """A (nested) dict of numpy arrays, e.g. the JAX param tree fetched to
    the host, as float32 tensors on ``device``."""
    return tree_map(lambda a: torch.as_tensor(
        np.asarray(a, np.float32), device=device).clone(), tree)


def to_numpy(tree: Any) -> Any:
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def _conv(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """VALID conv via im2col + GEMM: x (*lead, B, H, W, cin) with weights
    (*lead, kh, kw, cin, cout) -> (*lead, B, H', W', cout)."""
    w, b = p["w"], p["b"]
    lead = w.shape[:-4]
    kh, kw, cin, cout = w.shape[-4:]
    # every (i, j) window as one strided view (*lead, B, H', W', cin, kh,
    # kw), laid out (i, j, cin) like the reference's concatenation of the
    # kh*kw shifted slices; one copy forward, one unfold_backward backward
    win = x.unfold(-3, kh, 1).unfold(-3, kw, 1)
    f = kh * kw * cin
    patches = win.movedim(-3, -1).reshape(*win.shape[:-3], f)
    wm = w.reshape(*lead, f, cout)
    y = patches.reshape(*lead, -1, f) @ wm          # (*lead, B*H'*W', cout)
    y = y.reshape(*patches.shape[:-1], cout)
    return y + b.reshape(*lead, 1, 1, 1, cout)


def _dense(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """x (*lead, B, in) @ w (*lead, in, out) + b."""
    b = p["b"]
    return x @ p["w"] + b.reshape(*b.shape[:-1], 1, b.shape[-1])


def _pool(x: torch.Tensor) -> torch.Tensor:
    *rest, h, w, c = x.shape
    return x.reshape(*rest, h // 2, 2, w // 2, 2, c).amax(dim=(-4, -2))


def lenet_forward(params: Params, images: torch.Tensor) -> torch.Tensor:
    """images (*lead, B, H, W, C) -> logits (*lead, B, num_classes)."""
    x = _pool(torch.relu(_conv(images, params["c1"])))
    x = _pool(torch.relu(_conv(x, params["c2"])))
    x = x.reshape(*x.shape[:-3], -1)
    x = torch.relu(_dense(x, params["f1"]))
    x = torch.relu(_dense(x, params["f2"]))
    return _dense(x, params["f3"])


def lenet_loss(params: Params,
               batch: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """Mean cross-entropy over the batch axis: () or (*lead,) per model."""
    images, labels = batch
    logits = lenet_forward(params, images)
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (logz - ll).mean(dim=-1)


def lenet_accuracy(params: Params, images: torch.Tensor,
                   labels: torch.Tensor) -> torch.Tensor:
    pred = torch.argmax(lenet_forward(params, images), dim=-1)
    return (pred == labels.long()).float().mean(dim=-1)
