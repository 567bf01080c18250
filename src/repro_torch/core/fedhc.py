"""FedHC run configuration, the per-client training pieces and the
history-dict entry point.

Counterpart of ``repro/core/fedhc.py``: :class:`FLRunConfig` (same fields
and defaults, so configs and manifests carry across), per-client local
SGD, the §III-C MAML meta-update of re-formed clusters, :func:`run_fl`
and :func:`time_energy_to_accuracy` (paper Table I's metric over a
history dict) and the live :data:`METHODS` view of the strategy registry.
The reference's ``vmap`` over clients is a leading client dimension here
(`models/lenet.py`); its host-loop oracle ``run_fl_legacy`` is not ported
(ROADMAP queue 1, slice 15).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from repro_torch.core import aggregation as agg
from repro_torch.core import maml as maml_lib
from repro_torch.core import strategies as strat_lib
from repro_torch.data.synthetic import MNIST_LIKE, DatasetSpec
from repro_torch.models.lenet import lenet_loss
from repro_torch.tree import tree_map


class _MethodsView:
    """Live, registry-ordered view of every registered method name: a
    strategy registered later shows up in ``in``, iteration, ``len`` and
    indexing (the reference's ``_MethodsView``).  :func:`methods` returns
    a plain tuple."""

    def __iter__(self):
        return iter(strat_lib.names())

    def __len__(self) -> int:
        return len(strat_lib.names())

    def __getitem__(self, i):
        return strat_lib.names()[i]

    def __contains__(self, method) -> bool:
        return method in strat_lib.names()

    def __eq__(self, other):
        try:
            return tuple(self) == tuple(other)
        except TypeError:             # not iterable: not equal, not an error
            return NotImplemented

    def __hash__(self):
        return hash(strat_lib.names())

    def __repr__(self) -> str:
        return f"METHODS{strat_lib.names()!r}"


METHODS = _MethodsView()      # every registered method, live


def methods() -> tuple:
    """Snapshot of the registered method names (registry-ordered)."""
    return strat_lib.names()


@dataclass(frozen=True)
class FLRunConfig:
    method: str = "fedhc"
    num_clients: int = 64
    num_clusters: int = 4                 # K
    rounds: int = 150
    rounds_per_global: int = 5            # m
    local_steps: int = 2                  # SGD steps per round (lambda)
    batch_size: int = 64
    lr: float = 0.01
    dropout_threshold: float = 0.5        # Z
    maml_alpha: float = 1e-3
    maml_beta: float = 1e-3
    dataset: DatasetSpec = MNIST_LIKE
    samples_per_client: int = 128
    dirichlet_alpha: float = 0.5
    eval_every: int = 5
    eval_size: int = 1024
    seed: int = 0
    round_minutes: float = 1.0            # orbital time advanced per round
    # time-varying connectivity (visibility-gated strategies)
    contact_dt_s: float = 60.0
    gs_min_elevation_deg: float = 10.0
    isl_max_range_km: float = 8000.0
    isl_max_hops: int = 8
    contact_dtype: str = "float32"
    use_pallas_kernels: bool = False      # the name is the reference's; here
    #                                       it routes the drift check and
    #                                       every stage-1 through the Hopper
    #                                       kernels (kmeans_assign,
    #                                       weighted_agg_multi)
    contact_slices: bool = False
    contact_factorized: bool = False
    telemetry: bool = False
    client_microbatch: int = 0            # train clients in blocks of this
    #                                       size (0 = all at once)
    # asynchronous buffered aggregation (async strategies:
    # core/async_engine.py)
    async_cohort: int = 0
    async_buffer: int = 0
    staleness: str = "polynomial"
    staleness_a: float = 0.5
    staleness_b: float = 4.0
    server_lr: float = 1.0

    def to_scenario(self):
        from repro_torch.core.scenario import Scenario
        return Scenario.from_flat(self)


def _train_block(params: Any, images, labels, lr: float,
                 steps: int) -> Tuple[Any, torch.Tensor]:
    loss = None
    for _ in range(steps):
        loss, g = maml_lib.grad_tree(lenet_loss, params, (images, labels))
        params = maml_lib.sgd_tree(params, g, lr)
    return params, loss


def _local_train(params_stack: Any, images, labels, lr: float, steps: int,
                 *, microbatch: int = 0) -> Tuple[Any, torch.Tensor]:
    """Per-client local SGD, ``steps`` steps each, all clients at once
    (params (C, ...), images (C, B, H, W, ch)).  Returns the new stack and
    each client's loss at its last step, (C,).

    ``microbatch=m`` trains blocks of m clients in turn, capping
    activation memory at O(m) clients; the math per client is the same,
    so results agree with the full batch to float rounding."""
    if steps < 1:
        raise ValueError(f"local_steps={steps}: federated methods train at "
                         f"least one step per round")
    c = images.shape[0]
    mb = int(microbatch)
    if not mb or mb >= c:
        return _train_block(params_stack, images, labels, lr, steps)
    parts = [_train_block(tree_map(lambda x: x[i:i + mb], params_stack),
                          images[i:i + mb], labels[i:i + mb], lr, steps)
             for i in range(0, c, mb)]
    params = tree_map(lambda *xs: torch.cat(xs), *[p for p, _ in parts])
    return params, torch.cat([l for _, l in parts])


def _meta_update_clusters(cluster_models: Any, assignment, images, labels,
                          *, k: int, alpha: float, beta: float) -> Any:
    """Eq. 16-17 per cluster: each member inner-adapts its copy of its
    cluster model on its own batch; the cluster model steps along the
    membership-summed gradients its members take at their adapted weights
    (``grad L(w')``, as the reference computes them)."""
    member = agg.broadcast_clusters(cluster_models, assignment)
    adapted = maml_lib.inner_adapt(lenet_loss, member, (images, labels),
                                   alpha)
    _, grads = maml_lib.grad_tree(lenet_loss, adapted, (images, labels))
    one_hot = agg.membership_one_hot(assignment, k)               # (C,K)

    def per_cluster(m, g):
        summed = one_hot.T @ g.reshape(g.shape[0], -1)            # (K,P)
        return m - beta * summed.reshape(m.shape)
    return tree_map(per_cluster, cluster_models, grads)


def run_fl(cfg: FLRunConfig, verbose: bool = False, *,
           device=None) -> Dict[str, list]:
    """Run a full FL experiment on ``device`` (default ``cuda``): the
    history dict with entries at every ``eval_every``-th round (plus the
    last) and the re-cluster count.  Routes through ``engine.run``, which
    sends async strategies to the event engine."""
    from repro_torch.core import engine   # late: engine imports this module
    return engine.run(cfg, verbose=verbose, device=device)


def time_energy_to_accuracy(history: Dict[str, list], target: float):
    """First ``(time, energy, round)`` at which accuracy >= target, else
    ``(inf, inf, -1)``.  The typed form is ``RunResult.time_to_accuracy``
    (`repro_torch/api.py`), which returns None when never reached."""
    for r, a, t, e in zip(history["round"], history["acc"],
                          history["time_s"], history["energy_j"]):
        if a >= target:
            return t, e, r
    return float("inf"), float("inf"), -1
