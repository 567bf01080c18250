"""FL strategy registry: each method as declarative engine policies.

Counterpart of ``repro/core/strategies.py``, as data: the same
:class:`Strategy` fields and validation and the same ten registered
strategies, so ``Scenario`` validation and content hashes agree with the
JAX package.  This slice's engine runs the five always-up paper methods;
the others raise ``NotImplementedError`` in `core/engine.py` naming their
ROADMAP slice.

``CLUSTER_INITS`` maps an init name to ``fn(gen, positions, label_hists,
k) -> (assignment, centroids)``, drawing from the ``torch.Generator``
``gen``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import torch

from repro_torch.core import clustering as cl

ClusterInitFn = Callable[[torch.Generator, torch.Tensor, torch.Tensor, int],
                         Tuple[torch.Tensor, torch.Tensor]]


def _kmeans_init_idx(gen: torch.Generator, n: int, k: int) -> torch.Tensor:
    """k distinct random indices (the paper: 'K centroids are randomly
    selected from the satellite location data')."""
    return torch.randperm(n, generator=gen, device=gen.device)[:k]


def _init_position(gen, positions, label_hists, k):
    """Paper §III-B: k-means over satellite position vectors."""
    res = cl.kmeans(positions, k, _kmeans_init_idx(gen, positions.shape[0], k))
    return res.assignment, res.centroids


def _init_label_hist(gen, positions, label_hists, k):
    """FedCE-style: cluster in label-distribution space, then place the
    position-space centroids at the mean member position (seeded from the
    label-space PS picks) so geometry drift is still measurable."""
    res = cl.kmeans(label_hists, k,
                    _kmeans_init_idx(gen, label_hists.shape[0], k))
    centroids = cl.update_centroids(positions, res.assignment,
                                    positions[res.ps_index.long()])
    return res.assignment, centroids


def _init_random(gen, positions, label_hists, k):
    """H-BASE: random static clusters."""
    n = positions.shape[0]
    assignment = torch.randint(0, k, (n,), generator=gen,
                               device=gen.device).to(torch.int32)
    return assignment, cl.update_centroids(positions, assignment,
                                           positions[:k])


def _init_single(gen, positions, label_hists, k):
    """Centralized baseline: everyone in one cluster (K must be 1)."""
    n = positions.shape[0]
    assignment = torch.zeros((n,), dtype=torch.int32,
                             device=positions.device)
    return assignment, positions.mean(0, keepdim=True)


CLUSTER_INITS: Dict[str, ClusterInitFn] = {
    "position": _init_position,
    "label_hist": _init_label_hist,
    "random": _init_random,
    "single": _init_single,
}


@dataclass(frozen=True)
class Strategy:
    """A federated-learning method as composable engine policies."""
    name: str
    cluster_init: str = "position"     # key into CLUSTER_INITS
    weighting: str = "loss"            # "loss" (Eq. 12) | "data" (Eq. 5)
    recluster: str = "dropout"         # "dropout" (Alg. 1) | "never"
    inherit: str = "maml"              # "maml" (§III-C) | "copy"
    cost_model: str = "hierarchical"   # "hierarchical" | "centralized"
    connectivity: str = "always"       # "always" | "visibility" | "isl"
    aggregation: str = "sync"          # "sync" | "async-buffered"
    description: str = ""

    def __post_init__(self):
        if self.cluster_init not in CLUSTER_INITS:
            raise ValueError(f"unknown cluster_init {self.cluster_init!r}; "
                             f"known: {sorted(CLUSTER_INITS)}")
        for fld, val, ok in (("weighting", self.weighting, ("loss", "data")),
                             ("recluster", self.recluster,
                              ("dropout", "never")),
                             ("inherit", self.inherit, ("maml", "copy")),
                             ("cost_model", self.cost_model,
                              ("hierarchical", "centralized")),
                             ("connectivity", self.connectivity,
                              ("always", "visibility", "isl")),
                             ("aggregation", self.aggregation,
                              ("sync", "async-buffered"))):
            if val not in ok:
                raise ValueError(f"{fld}={val!r} not in {ok}")
        if self.connectivity != "always" and self.cost_model == "centralized":
            raise ValueError("connectivity gating requires the hierarchical "
                             "cost model")
        if self.aggregation == "async-buffered" and (
                self.cost_model == "centralized"
                or self.recluster != "never" or self.connectivity == "isl"):
            raise ValueError("async-buffered aggregation needs the "
                             "hierarchical cost model, recluster='never' and "
                             "connectivity 'always' or 'visibility'")

    @property
    def loss_weighted(self) -> bool:
        return self.weighting == "loss"

    @property
    def reclusters(self) -> bool:
        return self.recluster == "dropout"

    @property
    def maml(self) -> bool:
        return self.inherit == "maml"

    @property
    def centralized(self) -> bool:
        return self.cost_model == "centralized"

    @property
    def visibility_gated(self) -> bool:
        return self.connectivity != "always"

    @property
    def shardable(self) -> bool:
        return not self.centralized

    @property
    def is_async(self) -> bool:
        return self.aggregation == "async-buffered"


_REGISTRY: Dict[str, Strategy] = {}


def register(strategy: Strategy) -> Strategy:
    """Register (or replace) a strategy under ``strategy.name``."""
    _REGISTRY[strategy.name] = strategy
    return strategy


def get(name: str) -> Strategy:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown FL strategy {name!r}; "
                       f"registered: {names()}") from None


def names() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


# The registry as data: (name, cluster_init, weighting, recluster, inherit,
# cost_model, connectivity, aggregation, description), in the reference's
# registration order.  The descriptions are the reference's, verbatim:
# they are part of ``dataclasses.asdict(strategy)``.
_ENTRIES = (
    ("fedhc", "position", "loss", "dropout", "maml", "hierarchical",
     "always", "sync",
     "position k-means + PS selection, loss-weighted stage-1, stage-2 every "
     "m rounds, MAML on re-cluster"),
    ("fedhc-nomaml", "position", "loss", "dropout", "copy", "hierarchical",
     "always", "sync",
     "ablation: re-clusters but new members copy the cluster model cold"),
    ("h-base", "random", "data", "never", "copy", "hierarchical", "always",
     "sync", "random static clusters, data-size weights, no re-cluster"),
    ("fedce", "label_hist", "data", "never", "copy", "hierarchical",
     "always", "sync",
     "clusters on label-distribution space, data-size weights, no MAML"),
    ("c-fedavg", "single", "data", "never", "copy", "centralized", "always",
     "sync", "centralized: raw data to one satellite server (K=1)"),
    ("fedspace", "position", "data", "never", "copy", "hierarchical",
     "visibility", "sync",
     "FedSpace-style (arXiv 2202.01267): participation gated by ISL "
     "reachability to the cluster PS, hop-aware upload costs, and global "
     "aggregation deferred until a ground-station contact window (relay via "
     "the visible gateway satellite)"),
    ("isl-onboard", "position", "loss", "never", "copy", "hierarchical",
     "isl", "sync",
     "fully on-board FL (arXiv 2307.08346): no ground station; stage 2 is an "
     "all-to-all cluster-model exchange between PSs over multi-hop ISL "
     "routes, fired when every PS pair is mutually reachable"),
    ("fedbuff", "single", "data", "never", "copy", "hierarchical", "always",
     "async-buffered",
     "FedBuff (Nguyen et al., AISTATS 2022): flat single-server buffered "
     "async — clients run on their own virtual clocks, the server aggregates "
     "whenever the update buffer fills, updates weighted by a "
     "staleness-decay schedule"),
    ("fedhc-async", "position", "loss", "never", "copy", "hierarchical",
     "always", "async-buffered",
     "FedHC on the async engine: stage-1 is per-cluster buffered async "
     "(loss x staleness-decay weights, each PS advances when its own buffer "
     "fills), stage-2 is a buffered all-cluster aggregation fired after "
     "every cluster has committed m flushes"),
    ("fedspace-async", "position", "data", "never", "copy", "hierarchical",
     "visibility", "async-buffered",
     "FedSpace x FedBuff hybrid: per-cluster buffered async with "
     "contact-plan gating — upload validity and route costs are looked up "
     "at each client's OWN clock, and the buffered stage-2 defers until a "
     "ground-station window"),
)
for _e in _ENTRIES:
    register(Strategy(*_e))

# the five always-up paper methods (§IV-A), the ones this slice runs
PAPER_METHODS = names()[:5]
