"""Meta-learning re-clustering adaptation (paper §III-C).

Counterpart of ``repro/core/maml.py``: MAML over satellite tasks, the
inner step (Eq. 16) ``w' = w - alpha * grad L(w)`` and the outer
meta-update (Eq. 17) ``w <- w - beta * grad_w mean_i L_i(w'_i)``.

``meta_step`` differentiates *through* the inner update (exact MAML);
``first_order=True`` gives the FOMAML approximation (each inner gradient
taken as a constant).  ``adapt_new_member`` is what a newly joined
satellite runs: a few inner steps from its cluster head's model.

With a leading client dimension the loss is per client and the gradient
of its sum is each client's own gradient (clients share no parameters):
the engine's calls take that form, on tensors that carry no graph.
"""
from __future__ import annotations

from typing import Any, Callable, Tuple

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


def _carries_graph(params: Any) -> bool:
    return torch.is_grad_enabled() and any(
        p.requires_grad for p in tree_leaves(params))


def inner_adapt(loss_fn: Callable, params: Any, batch, alpha: float,
                steps: int = 1, first_order: bool = False) -> Any:
    """Eq. 16, ``steps`` times.  ``loss_fn(params, batch)`` -> a scalar,
    or one loss a client.

    Where a leaf of ``params`` requires grad, the result stays
    differentiable in ``params``, as the reference's is under
    ``jax.grad``: exact mode keeps each step's gradient in the graph
    (``create_graph``), so differentiating the result takes the second
    derivatives through every step; ``first_order`` takes each step's
    gradient as a constant (the reference's ``stop_gradient``), and the
    result depends on ``params`` through ``p - alpha * g`` alone.  Where
    none does (the engine's calls), each gradient is taken on detached
    copies and no graph is kept: the two modes agree there."""
    if not _carries_graph(params):
        for _ in range(steps):
            _, g = grad_tree(loss_fn, params, batch)
            params = sgd_tree(params, g, alpha)
        return params
    for _ in range(steps):
        leaves = [p if p.requires_grad else p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        params = tree_unflatten(params, leaves)
        g = torch.autograd.grad(loss_fn(params, batch).sum(), leaves,
                                create_graph=not first_order)
        params = sgd_tree(params, tree_unflatten(params, list(g)), alpha)
    return params


def meta_step(loss_fn: Callable, params: Any, support_batches,
              query_batches, alpha: float, beta: float,
              inner_steps: int = 1,
              first_order: bool = False) -> Tuple[Any, torch.Tensor]:
    """Eq. 17 over a batch of tasks.

    ``support_batches``/``query_batches``: trees whose leaves carry a
    leading task dimension.  Each task adapts its own copy of ``params``
    on its support batch (:func:`inner_adapt`, ``inner_steps`` steps)
    and is scored on its query batch: a plain loop over the tasks (the
    reference vmaps them), all from one copy of ``params`` that requires
    grad.  The mean of the losses is differentiated once, and one SGD
    step of ``beta`` taken.  Returns (new meta-params, mean
    post-adaptation query loss), both detached."""
    with torch.enable_grad():
        p = tree_map(lambda x: x.detach().requires_grad_(True), params)
        n = tree_leaves(support_batches)[0].shape[0]
        losses = []
        for i in range(n):
            adapted = inner_adapt(
                loss_fn, p, tree_map(lambda x: x[i], support_batches),
                alpha, inner_steps, first_order)
            losses.append(loss_fn(adapted,
                                  tree_map(lambda x: x[i], query_batches)))
        loss = torch.stack(losses).mean()
        g = torch.autograd.grad(loss, tree_leaves(p))
    new = sgd_tree(tree_map(torch.Tensor.detach, p),
                   tree_unflatten(p, list(g)), beta)
    return new, loss.detach()


def adapt_new_member(loss_fn: Callable, cluster_model: Any, local_batch,
                     alpha: float, steps: int = 2) -> Any:
    """What a satellite that just joined a cluster runs: start from the
    cluster head's model ('inherits model updates from the head node') and
    take one-two inner steps on its own data (§III-C)."""
    return inner_adapt(loss_fn, cluster_model, local_batch, alpha, steps)
