"""Meta-learning re-clustering adaptation (paper §III-C).

Counterpart of ``repro/core/maml.py``: the inner step (Eq. 16)
``w' = w - alpha * grad L(w)``.  With a leading client dimension the loss
is per client and the gradient of its sum is each client's own gradient
(clients share no parameters).
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def sgd_tree(params: Any, grads: Any, lr: float) -> Any:
    return tree_map(lambda p, g: p - lr * g.to(p.dtype), params, grads)


def grad_tree(loss_fn: Callable, params: Any, batch):
    """(loss, grads) of ``loss_fn(params, batch).sum()`` w.r.t. every
    leaf, taken on detached copies (the caller's tensors are untouched);
    the returned loss is detached too."""
    params = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss = loss_fn(params, batch)
    grads = torch.autograd.grad(loss.sum(), tree_leaves(params))
    return loss.detach(), tree_unflatten(params, list(grads))


def inner_adapt(loss_fn: Callable, params: Any, batch, alpha: float,
                steps: int = 1) -> Any:
    """Eq. 16, ``steps`` times."""
    for _ in range(steps):
        _, g = grad_tree(loss_fn, params, batch)
        params = sgd_tree(params, g, alpha)
    return params
