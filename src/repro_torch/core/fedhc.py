"""FedHC run configuration, the per-client training pieces and the
history-dict entry point.

Counterpart of ``repro/core/fedhc.py``: :class:`FLRunConfig` (same fields
and defaults, so configs and manifests carry across), per-client local
SGD, the §III-C MAML meta-update of re-formed clusters, :func:`run_fl`
and :func:`time_energy_to_accuracy` (paper Table I's metric over a
history dict) and the live :data:`METHODS` view of the strategy registry.
The reference's ``vmap`` over clients is a leading client dimension here
(`models/lenet.py`).  :func:`run_fl_legacy` is the reference's host-loop
oracle: one round a loop iteration with the clock kept in Python floats,
taking the setup and the per-round draws the engine takes, so the two
can be held against each other on the same inputs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

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
                 *, microbatch: int = 0,
                 client_shards: int = 1) -> Tuple[Any, torch.Tensor]:
    """Per-client local SGD, ``steps`` steps each, all clients at once
    (params (C, ...), images (C, B, H, W, ch)).  Returns the new stack and
    each client's loss at its last step, (C,).

    ``microbatch=m`` trains blocks of m clients in turn, capping
    activation memory at O(m) clients; the math per client is the same,
    so results agree with the full batch to float rounding.

    On a client mesh the stack is this rank's rows of C = rows * S
    (``client_shards=S``), and a block takes m/S of them, the reference's
    device-local decomposition: it needs ``m % S == 0`` and
    ``(C/S) % (m/S) == 0`` (raised here otherwise; `core/scenario.py`
    checks the same at construction)."""
    if steps < 1:
        raise ValueError(f"local_steps={steps}: federated methods train at "
                         f"least one step per round")
    c = images.shape[0]
    mb, s = int(microbatch), max(1, int(client_shards))
    if not mb or mb >= c * s:
        return _train_block(params_stack, images, labels, lr, steps)
    if s > 1:
        if mb % s or c % (mb // s):
            raise ValueError(
                f"client_microbatch={mb} does not decompose device-locally "
                f"over {s} client shards: need microbatch % shards == 0 "
                f"and (num_clients//shards) % (microbatch//shards) == 0 "
                f"(num_clients={c * s})")
        mb //= s
    parts = [_train_block(tree_map(lambda x: x[i:i + mb], params_stack),
                          images[i:i + mb], labels[i:i + mb], lr, steps)
             for i in range(0, c, mb)]
    params = tree_map(lambda *xs: torch.cat(xs), *[p for p, _ in parts])
    return params, torch.cat([l for _, l in parts])


def _meta_update_clusters(cluster_models: Any, assignment, images, labels,
                          *, k: int, alpha: float, beta: float,
                          reduce: Optional[Callable[[Any], Any]] = None
                          ) -> Any:
    """Eq. 16-17 per cluster: each member inner-adapts its copy of its
    cluster model on its own batch; the cluster model steps along the
    membership-summed gradients its members take at their adapted weights
    (``grad L(w')``, as the reference computes them).  On a client mesh
    ``assignment``, ``images`` and ``labels`` are this rank's rows and
    ``reduce`` sums the (K, ...) partial gradient sums over the ranks."""
    member = agg.broadcast_clusters(cluster_models, assignment)
    adapted = maml_lib.inner_adapt(lenet_loss, member, (images, labels),
                                   alpha)
    _, grads = maml_lib.grad_tree(lenet_loss, adapted, (images, labels))
    one_hot = agg.membership_one_hot(assignment, k)               # (C,K)
    summed = tree_map(lambda g: one_hot.T @ g.reshape(g.shape[0], -1),
                      grads)                                      # (K,P)
    if reduce is not None:
        summed = reduce(summed)
    return tree_map(lambda m, g: m - beta * g.reshape(m.shape),
                    cluster_models, summed)


def run_fl(cfg: FLRunConfig, verbose: bool = False, *,
           device=None) -> Dict[str, list]:
    """Run a full FL experiment on ``device`` (default ``cuda``): the
    history dict with entries at every ``eval_every``-th round (plus the
    last) and the re-cluster count.  Routes through ``engine.run``, which
    sends async strategies to the event engine."""
    from repro_torch.core import engine   # late: engine imports this module
    return engine.run(cfg, verbose=verbose, device=device)


def run_fl_legacy(cfg: FLRunConfig, verbose: bool = False, *, device=None,
                  state0=None, data=None, draws=None) -> Dict[str, list]:
    """The original host-side round loop (host reads every round), for the
    five always-up paper methods: the reference's ``run_fl_legacy``.

    Kept as an oracle for the engine (`core/engine.py`): it takes the
    engine's setup (``state0``/``data``, else ``engine.setup``) and its
    draws (``draws``, else ``engine.TorchDraws``; the parity tests pass
    ``ArrayDraws`` of the reference's), and returns the history dict
    without ``global_rounds``, as the reference's does."""
    from repro_torch.core import engine    # late: engine imports this module
    from repro_torch import device as device_lib
    from repro_torch.core import clustering as cl
    from repro_torch.data.synthetic import client_batches
    from repro_torch.models.lenet import lenet_accuracy
    from repro_torch.orbits import cost as cost_lib
    from repro_torch.orbits.constellation import ground_station_position
    from repro_torch.orbits.links import LinkParams
    from repro_torch.tree import tree_leaves

    if cfg.method not in strat_lib.PAPER_METHODS:
        raise ValueError(f"run_fl_legacy runs the paper methods "
                         f"{strat_lib.PAPER_METHODS}, not {cfg.method!r}")
    dev = device_lib.resolve(device)
    if (state0 is None) != (data is None):
        raise ValueError("pass both state0 and data, or neither")
    if state0 is None:
        state0, data = engine.setup(cfg, device=dev)
    if draws is None:
        draws = engine.TorchDraws(cfg, cfg.seed, dev)
    central = cfg.method == "c-fedavg"
    k = 1 if central else cfg.num_clusters
    maml = cfg.method == "fedhc"
    reclusters = cfg.method in ("fedhc", "fedhc-nomaml")
    n_params = sum(x.numel() for x in tree_leaves(state0.params))
    model_bits = (n_params if central else n_params // cfg.num_clients) * 32.0
    sample_bits = cfg.dataset.img ** 2 * cfg.dataset.channels * 32.0
    constellation = engine._constellation_for(cfg.num_clients)
    lp, cp = LinkParams(), cost_lib.ComputeParams()
    params = state0.params
    assignment, centroids, ps_index = (state0.assignment, state0.centroids,
                                       state0.ps_index)

    history = {"round": [], "acc": [], "loss": [], "time_s": [],
               "energy_j": [], "reclusters": 0}
    t_sim, e_sim = 0.0, 0.0
    for rnd in range(cfg.rounds):
        positions = constellation.positions(t_sim, device=dev)
        gs = ground_station_position(t_s=t_sim, device=dev)
        do_global = (rnd + 1) % cfg.rounds_per_global == 0
        if central:
            # the server performs all clients' steps serially
            def batch(step):
                picks = draws.central_picks(rnd, step)
                return data.images[picks], data.labels[picks]
            for step in range(cfg.local_steps):
                loss, g = maml_lib.grad_tree(lenet_loss, params, batch(step))
                params = maml_lib.sgd_tree(params, g, cfg.lr)
            if cfg.local_steps == 0:
                loss = lenet_loss(params, batch(0))
            participating = torch.ones((cfg.num_clients,), dtype=torch.bool,
                                       device=dev)
            t_r, e_r = cost_lib.cfedavg_round_costs(
                positions, positions[int(ps_index[0])], participating,
                data.data_sizes, data.freqs, sample_bits=sample_bits,
                server_freq_hz=cp.max_freq_hz, lp=lp, cp=cp)
            loss_val = float(loss)
        else:
            imgs, labs = client_batches(data.images, data.labels,
                                        data.client_idx,
                                        draws.batch_picks(rnd))
            in_region = cl.assign(positions, centroids) == assignment
            participating = torch.ones_like(in_region)
            params, losses = _local_train(params, imgs, labs, lr=cfg.lr,
                                          steps=cfg.local_steps)
            params = agg.hierarchical_round(
                params, losses, data.data_sizes, assignment, k,
                participating, do_global=do_global,
                loss_weighted=reclusters)
            loss_val = float(losses.mean())
            ps_l = ps_index.long()
            t_r, e_r = cost_lib.cluster_round_costs(
                positions, positions[ps_l][assignment.long()], assignment,
                participating, data.data_sizes, data.freqs,
                model_bits=model_bits, lp=lp, cp=cp)
            if do_global:
                t_g, e_g = cost_lib.ground_round_costs(
                    positions[ps_l], gs, model_bits=model_bits, lp=lp)
                t_r, e_r = t_r + t_g, e_r + e_g

            # ---- re-cluster check (Alg. 1 lines 14-18) -------------------
            if reclusters and do_global and float(cl.dropout_rate(
                    in_region, assignment, k).max()) > cfg.dropout_threshold:
                history["reclusters"] += 1
                res = cl.kmeans(positions, k, draws.kmeans_init(rnd))
                new_assignment = res.assignment
                cluster_models = agg.cluster_aggregate(
                    params, agg.loss_weights(losses, new_assignment, k),
                    new_assignment, k)
                if maml:
                    cluster_models = _meta_update_clusters(
                        cluster_models, new_assignment, imgs, labs, k=k,
                        alpha=cfg.maml_alpha, beta=cfg.maml_beta)
                inherited = agg.broadcast_clusters(cluster_models,
                                                   new_assignment)
                if maml:
                    # each joining member takes MAML inner steps on its
                    # own data from the meta-updated cluster model
                    inherited = maml_lib.inner_adapt(
                        lenet_loss, inherited, (imgs, labs), cfg.maml_alpha)
                changed = new_assignment != assignment
                params = tree_map(
                    lambda inh, old: torch.where(
                        changed.reshape((-1,) + (1,) * (inh.dim() - 1)),
                        inh, old), inherited, params)
                assignment, centroids, ps_index = (
                    new_assignment, res.centroids, res.ps_index)

        t_sim += float(t_r) + cfg.round_minutes * 60.0
        e_sim += float(e_r)

        if (rnd + 1) % cfg.eval_every == 0 or rnd == cfg.rounds - 1:
            model = (params if central else
                     tree_map(lambda x: x.float().mean(0), params))
            acc = float(lenet_accuracy(model, data.test_x, data.test_y))
            history["round"].append(rnd + 1)
            history["acc"].append(acc)
            history["loss"].append(loss_val)
            history["time_s"].append(t_sim)
            history["energy_j"].append(e_sim)
            if verbose:
                print(f"[{cfg.method} K={k}] round {rnd + 1:4d} "
                      f"acc={acc:.3f} loss={loss_val:.3f} "
                      f"T={t_sim:.0f}s E={e_sim:.1f}J")
    return history


def time_energy_to_accuracy(history: Dict[str, list], target: float):
    """First ``(time, energy, round)`` at which accuracy >= target, else
    ``(inf, inf, -1)``.  The typed form is ``RunResult.time_to_accuracy``
    (`repro_torch/api.py`), which returns None when never reached."""
    for r, a, t, e in zip(history["round"], history["acc"],
                          history["time_s"], history["energy_j"]):
        if a >= target:
            return t, e, r
    return float("inf"), float("inf"), -1
