"""Staleness-decay weighting for asynchronous buffered aggregation.

Counterpart of ``repro/core/staleness.py``.  In the async engine
(`core/async_engine.py`) a buffered client update carries a staleness
``tau = v_cluster - v_client``: the model versions its cluster advanced
between the client fetching its base model and its update arriving.  A
schedule maps ``tau`` to a weight ``s(tau)`` in (0, 1] folded into the
client's aggregation weight before the per-cluster normalization.

Schedules are an open registry keyed by ``FLRunConfig.staleness``:

* ``constant``: ``s(tau) = 1`` (staleness ignored; with buffer = cohort =
  C the async engine reproduces the sync trajectory);
* ``polynomial``: ``s(tau) = (1 + tau)^(-a)`` (FedAsync/FedBuff);
* ``hinge``: ``s(tau) = 1`` while ``tau <= b``, then
  ``1 / (1 + a * (tau - b))``.

Every schedule is monotone non-increasing in ``tau`` and 1 at
``tau = 0``.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

# fn(tau f32 tensor, a, b) -> weight in (0, 1], any shape
StalenessFn = Callable[[torch.Tensor, float, float], torch.Tensor]

STALENESS_FNS: Dict[str, StalenessFn] = {}


def staleness_schedule(name: str) -> Callable[[StalenessFn], StalenessFn]:
    """Decorator: register a staleness schedule under ``name``."""
    def deco(fn: StalenessFn) -> StalenessFn:
        STALENESS_FNS[name] = fn
        return fn
    return deco


@staleness_schedule("constant")
def _constant(tau, a, b):
    """s(tau) = 1 exactly: ``1.0 * x == x``, which the sync-equivalence
    pin relies on."""
    return torch.ones_like(tau)


@staleness_schedule("polynomial")
def _polynomial(tau, a, b):
    return (1.0 + tau) ** (-a)


@staleness_schedule("hinge")
def _hinge(tau, a, b):
    return torch.where(tau <= b, 1.0, 1.0 / (1.0 + a * (tau - b)))


def decay(name: str, tau, *, a: float, b: float) -> torch.Tensor:
    """Schedule ``name`` at (integer or float) staleness ``tau``."""
    try:
        fn = STALENESS_FNS[name]
    except KeyError:
        raise KeyError(f"unknown staleness schedule {name!r}; "
                       f"registered: {names()}") from None
    return fn(torch.as_tensor(tau).float(), a, b)


def names() -> Tuple[str, ...]:
    return tuple(STALENESS_FNS)
