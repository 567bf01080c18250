"""Minimal tree optimizers: SGD (with momentum) and Adam.

Counterpart of ``repro/optim/optimizers.py``.  Functions on parameter
trees, not ``torch.optim``: the FL stack updates a client-stacked (C, ...)
tree, and these are elementwise, so one call updates every client (the
reference vmaps them).  State is float32; parameters keep their dtype.
The paper trains clients with small-batch SGD (lr 0.01); Adam is for
training the large architectures.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map


class OptState(NamedTuple):
    step: torch.Tensor        # () int32
    m: Any                    # momentum / first moment (or () for plain SGD)
    v: Any                    # second moment (Adam) or ()


def _zeros_like_f32(tree):
    return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                          device=x.device), tree)


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def sgd_init(params, momentum: float = 0.0) -> OptState:
    m = _zeros_like_f32(params) if momentum else ()
    return OptState(_step0(params), m, ())


def sgd_update(params, grads, state: OptState, *, lr: float,
               momentum: float = 0.0, weight_decay: float = 0.0
               ) -> Tuple[Any, OptState]:
    if weight_decay:
        grads = tree_map(lambda g, p: g + weight_decay * p.to(g.dtype),
                         grads, params)
    if momentum:
        m = tree_map(lambda mm, g: momentum * mm + g.float(), state.m, grads)
        upd = m
    else:
        m, upd = (), grads
    params = tree_map(
        lambda p, u: (p.float() - lr * u.float()).to(p.dtype), params, upd)
    return params, OptState(state.step + 1, m, ())


def adam_init(params) -> OptState:
    return OptState(_step0(params), _zeros_like_f32(params),
                    _zeros_like_f32(params))


def adam_update(params, grads, state: OptState, *, lr: float,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                weight_decay: float = 0.0) -> Tuple[Any, OptState]:
    step = state.step + 1
    t = step.float()
    m = tree_map(lambda mm, g: b1 * mm + (1 - b1) * g.float(), state.m, grads)
    v = tree_map(lambda vv, g: b2 * vv + (1 - b2) * torch.square(g.float()),
                 state.v, grads)
    mh = tree_map(lambda x: x / (1 - b1 ** t), m)
    vh = tree_map(lambda x: x / (1 - b2 ** t), v)

    def upd(p, mh_, vh_):
        u = mh_ / (torch.sqrt(vh_) + eps)
        if weight_decay:
            u = u + weight_decay * p.float()
        return (p.float() - lr * u).to(p.dtype)

    params = tree_map(upd, params, mh, vh)
    return params, OptState(step, m, v)


def make_optimizer(name: str, **kw) -> Tuple[Callable, Callable]:
    """Returns ``(init_fn(params), update_fn(params, grads, state))``."""
    if name == "sgd":
        mom = kw.get("momentum", 0.0)
        return (lambda p: sgd_init(p, mom),
                lambda p, g, s: sgd_update(
                    p, g, s, lr=kw["lr"], momentum=mom,
                    weight_decay=kw.get("weight_decay", 0.0)))
    if name == "adam":
        return (adam_init,
                lambda p, g, s: adam_update(
                    p, g, s, lr=kw["lr"],
                    weight_decay=kw.get("weight_decay", 0.0)))
    raise ValueError(name)
