"""Sync FedHC round engine for always-up links, on one device.

Counterpart of the single-device, ``connectivity="always"`` path of
``repro/core/engine.py``.  The reference compiles the whole run into one
``lax.scan``; here a round is eager PyTorch and the run is a Python loop
over :func:`fed_step` (or :func:`central_step` for c-fedavg).

Host synchronisation.  Everything a round computes stays on the device,
with exactly one exception: on a stage-2 round of a re-clustering method
(fedhc, fedhc-nomaml) the re-cluster decision ``max(dropout rate) > Z`` is
read on the host (one ``.item()``-style read), because the branch it
guards runs k-means and the MAML hand-off (the reference's
``lax.cond``).  ``do_global`` and ``evaluated`` depend only on the round
index for always-up methods, so they are Python values.  The history is
fetched once, after the last round.  So a run makes
``rounds // rounds_per_global`` syncs for fedhc/fedhc-nomaml and none for
h-base, fedce and c-fedavg, plus the final fetch.  (CUDA graphs, which
would also remove the per-kernel launch cost, come later.)

Randomness goes through a *draws* object with three methods:
``batch_picks(rnd) -> (C, B)``, ``kmeans_init(rnd) -> (K,)`` and
``central_picks(rnd, step) -> (B,)``.  :class:`TorchDraws` draws from a
``torch.Generator`` on the run's device, re-seeded per call from
``(seed, stream, round, step)`` so a draw does not depend on which draws
came before it (the reference's ``fold_in``).  :class:`ArrayDraws`
replays given arrays: the parity tests hand it the reference's draws.

Not in this slice (each raises ``NotImplementedError`` naming its ROADMAP
slice): visibility-gated strategies, the async engine, a client mesh,
telemetry and multi-seed sweeps.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import device as device_lib
from repro_torch.core import aggregation as agg
from repro_torch.core import clustering as cl
from repro_torch.core import maml as maml_lib
from repro_torch.core import strategies as strat_lib
from repro_torch.core.fedhc import (FLRunConfig, _local_train,
                                    _meta_update_clusters)
from repro_torch.data.synthetic import (client_batches, dirichlet_partition,
                                        make_split)
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.lenet import (from_numpy, init_lenet, lenet_accuracy,
                                      lenet_loss)
from repro_torch.orbits import cost as cost_lib
from repro_torch.orbits.constellation import (Constellation,
                                              ground_station_position)
from repro_torch.orbits.links import LinkParams
from repro_torch.tree import tree_leaves, tree_map


class RoundState(NamedTuple):
    """Everything one FL round mutates."""
    params: Any                # (C, ...) client stack, or the server model
    assignment: torch.Tensor   # (C,) int32 cluster id per satellite
    centroids: torch.Tensor    # (K, 3) position-space centroids
    ps_index: torch.Tensor     # (K,) int32 satellite chosen as cluster PS
    t_sim: torch.Tensor        # () f32 cumulative simulated time (s)
    e_sim: torch.Tensor        # () f32 cumulative energy (J)
    reclusters: int            # re-cluster events so far


class RoundOutput(NamedTuple):
    """The per-round history, one entry per round (numpy after
    :func:`simulate`)."""
    acc: Any                   # test accuracy (NaN on non-eval rounds)
    loss: Any                  # mean training loss this round
    time_s: Any                # cumulative time after this round
    energy_j: Any              # cumulative energy after this round
    reclustered: Any           # 0/1: re-cluster fired this round
    evaluated: Any             # bool: acc is valid this round
    did_global: Any            # 0/1: stage-2 aggregation fired


class SimData(NamedTuple):
    """Per-experiment tensors the rounds read but never mutate."""
    images: torch.Tensor       # (N, H, W, ch) training pool
    labels: torch.Tensor       # (N,) int64
    test_x: torch.Tensor
    test_y: torch.Tensor
    client_idx: torch.Tensor   # (C, samples_per_client) int64
    data_sizes: torch.Tensor   # (C,) f32
    freqs: torch.Tensor        # (C,) heterogeneous CPU frequencies


# ---------------------------------------------------------------------------
# Randomness
# ---------------------------------------------------------------------------

_MASK64 = (1 << 64) - 1


def _fold(*ints: int) -> int:
    """A 63-bit seed mixed from integers (splitmix64 steps)."""
    h = 0x9E3779B97F4A7C15
    for i in ints:
        h = ((h ^ (int(i) & _MASK64)) * 0xBF58476D1CE4E5B9) & _MASK64
        h ^= h >> 31
        h = (h * 0x94D049BB133111EB) & _MASK64
        h ^= h >> 29
    return h >> 1


def _generator(device: torch.device, *key: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(_fold(*key))
    return g


# setup streams and per-round streams, the reference's key-split layout
_S_DATA, _S_PART, _S_MODEL, _S_FREQ, _S_KMEANS, _S_LOOP = range(6)


class TorchDraws:
    """Native per-round draws from a generator on the run's device."""

    def __init__(self, cfg: FLRunConfig, seed: int, device: torch.device):
        self.cfg, self.seed = cfg, int(seed)
        self.k = (1 if strat_lib.get(cfg.method).centralized
                  else cfg.num_clusters)
        self.gen = torch.Generator(device=device)

    def _gen(self, *key: int) -> torch.Generator:
        self.gen.manual_seed(_fold(self.seed, *key))
        return self.gen

    def batch_picks(self, rnd: int) -> torch.Tensor:
        cfg = self.cfg
        return torch.randint(0, cfg.samples_per_client,
                             (cfg.num_clients, cfg.batch_size),
                             generator=self._gen(_S_LOOP, rnd),
                             device=self.gen.device)

    def kmeans_init(self, rnd: int) -> torch.Tensor:
        return torch.randperm(self.cfg.num_clients,
                              generator=self._gen(_S_KMEANS, rnd),
                              device=self.gen.device)[:self.k]

    def central_picks(self, rnd: int, step: int) -> torch.Tensor:
        cfg = self.cfg
        return torch.randint(0, cfg.num_clients * cfg.samples_per_client,
                             (cfg.batch_size,),
                             generator=self._gen(_S_LOOP, rnd, step + 1),
                             device=self.gen.device)


class ArrayDraws:
    """Replays given draws: ``batch_picks`` (R, C, B), ``kmeans_init``
    (R, K) and ``central_picks`` (R, S, B), indexed by round (and step).
    Moved to the device once, at construction."""

    def __init__(self, batch_picks, kmeans_init, central_picks, *,
                 device: torch.device):
        def dev(a):
            return torch.as_tensor(np.asarray(a), device=device).long()
        self._batch = dev(batch_picks)
        self._kmeans = dev(kmeans_init)
        self._central = dev(central_picks)

    def batch_picks(self, rnd: int) -> torch.Tensor:
        return self._batch[rnd]

    def kmeans_init(self, rnd: int) -> torch.Tensor:
        return self._kmeans[rnd]

    def central_picks(self, rnd: int, step: int) -> torch.Tensor:
        return self._central[rnd, step]


# ---------------------------------------------------------------------------
# Setup
# ---------------------------------------------------------------------------


def _strategy_for(cfg: FLRunConfig) -> strat_lib.Strategy:
    """The config's strategy, if this slice's engine runs it."""
    strategy = strat_lib.get(cfg.method)
    if strategy.is_async:
        raise NotImplementedError(
            f"{cfg.method!r} runs on the async event engine: not ported yet "
            f"(ROADMAP queue 1, slice 11: core/staleness.py and "
            f"core/async_engine.py)")
    if strategy.visibility_gated:
        raise NotImplementedError(
            f"{cfg.method!r} is visibility-gated: contact plans are not "
            f"ported yet (ROADMAP queue 1, slice 10: orbits/topology.py and "
            f"orbits/contact.py)")
    if cfg.telemetry:
        raise NotImplementedError(
            "telemetry is not ported yet (ROADMAP queue 1, slice 13: obs/)")
    return strategy


def _constellation_for(num_clients: int) -> Constellation:
    planes = int(math.sqrt(num_clients))
    while num_clients % planes:
        planes -= 1
    return Constellation(num_planes=planes,
                         sats_per_plane=num_clients // planes)


def _num_clusters(cfg: FLRunConfig, strategy: strat_lib.Strategy) -> int:
    return 1 if strategy.centralized else cfg.num_clusters


def _initial_state(cfg, strategy, w0, assignment0, centroids0, ps_index0,
                   device) -> RoundState:
    params0 = (w0 if strategy.centralized
               else agg.broadcast_global(w0, cfg.num_clients))
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return RoundState(params0, assignment0.to(torch.int32),
                      centroids0.float(), ps_index0.to(torch.int32),
                      zero, zero.clone(), 0)


def setup(cfg: FLRunConfig, seed: Optional[int] = None, *,
          device=None) -> Tuple[RoundState, SimData]:
    """One-time experiment setup on ``device`` (default ``cuda``):
    synthetic data, model init, the strategy's initial clustering and PS
    selection, all drawn from generators on the device."""
    dev = device_lib.resolve(device)
    strategy = _strategy_for(cfg)
    ds = cfg.dataset
    k = _num_clusters(cfg, strategy)
    n_total = cfg.num_clients * cfg.samples_per_client
    seed = cfg.seed if seed is None else seed

    (images, labels), (test_x, test_y) = make_split(
        _generator(dev, seed, _S_DATA), ds, n_total, cfg.eval_size)
    client_idx = dirichlet_partition(
        _generator(dev, seed, _S_PART), labels, cfg.num_clients,
        cfg.dirichlet_alpha, cfg.samples_per_client, ds.num_classes)
    w0 = init_lenet(_generator(dev, seed, _S_MODEL), ds.channels, ds.img,
                    ds.num_classes, device=dev)
    freqs = cost_lib.sample_freqs(_generator(dev, seed, _S_FREQ),
                                  cfg.num_clients, cost_lib.ComputeParams())

    pos0 = _constellation_for(cfg.num_clients).positions(0.0, device=dev)
    hists = F.one_hot(labels[client_idx], ds.num_classes).sum(1)
    hists = (hists / cfg.samples_per_client).float()
    init_fn = strat_lib.CLUSTER_INITS[strategy.cluster_init]
    assignment0, centroids0 = init_fn(_generator(dev, seed, _S_KMEANS),
                                      pos0, hists, k)
    ps_index0 = cl.ps_select(pos0, centroids0, assignment0, k)

    data_sizes = torch.full((cfg.num_clients,),
                            float(cfg.samples_per_client), device=dev)
    return (_initial_state(cfg, strategy, w0, assignment0, centroids0,
                           ps_index0, dev),
            SimData(images, labels, test_x, test_y, client_idx, data_sizes,
                    freqs))


def state_from_numpy(cfg: FLRunConfig, arrays: Dict[str, Any], *,
                     device=None) -> Tuple[RoundState, SimData]:
    """Setup from given arrays instead of draws: ``images``, ``labels``,
    ``test_x``, ``test_y``, ``client_idx``, ``w0`` (the LeNet param tree),
    ``freqs``, ``assignment0``, ``centroids0`` and ``ps_index0``, as numpy
    (e.g. fetched from the JAX package's ``engine.setup``)."""
    dev = device_lib.resolve(device)
    strategy = _strategy_for(cfg)

    def t(name, dtype):
        return torch.as_tensor(np.asarray(arrays[name]), device=dev).to(dtype)

    data = SimData(t("images", torch.float32), t("labels", torch.int64),
                   t("test_x", torch.float32), t("test_y", torch.int64),
                   t("client_idx", torch.int64),
                   torch.full((cfg.num_clients,),
                              float(cfg.samples_per_client), device=dev),
                   t("freqs", torch.float32))
    state = _initial_state(cfg, strategy, from_numpy(arrays["w0"], dev),
                           t("assignment0", torch.int32),
                           t("centroids0", torch.float32),
                           t("ps_index0", torch.int32), dev)
    return state, data


# ---------------------------------------------------------------------------
# Rounds
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class _Ctx:
    """What every round reads: config, resolved policies, data, draws."""
    cfg: FLRunConfig
    strategy: strat_lib.Strategy
    data: SimData
    draws: Any
    k: int
    constellation: Constellation
    model_bits: float
    use_kernels: bool
    lp: LinkParams = LinkParams()
    cp: cost_lib.ComputeParams = cost_lib.ComputeParams()


def _finish(ctx: _Ctx, state: RoundState, rnd: int, params, assignment,
            centroids, ps_index, reclustered: int, loss_val, t_r, e_r,
            did_global: int, global_model) -> Tuple[RoundState, tuple]:
    cfg = ctx.cfg
    t_new = state.t_sim + t_r + cfg.round_minutes * 60.0
    e_new = state.e_sim + e_r
    evaluated = (rnd + 1) % cfg.eval_every == 0 or rnd == cfg.rounds - 1
    if evaluated:
        acc = lenet_accuracy(global_model(), ctx.data.test_x,
                             ctx.data.test_y)
    else:
        acc = torch.full((), math.nan, device=t_new.device)
    new_state = RoundState(params, assignment, centroids, ps_index, t_new,
                           e_new, state.reclusters + reclustered)
    return new_state, (acc, loss_val, t_new, e_new, reclustered, evaluated,
                       did_global)


def fed_step(ctx: _Ctx, state: RoundState, rnd: int):
    """One federated round (fedhc / fedhc-nomaml / h-base / fedce)."""
    cfg, data, strategy, k = ctx.cfg, ctx.data, ctx.strategy, ctx.k
    positions = ctx.constellation.positions(state.t_sim)
    do_global = (rnd + 1) % cfg.rounds_per_global == 0

    imgs, labs = client_batches(data.images, data.labels, data.client_idx,
                                ctx.draws.batch_picks(rnd))

    # geometry drift: a satellite whose nearest centroid changed has
    # "left" its cluster (Alg. 1) -- drives the dropout rate
    if ctx.use_kernels:
        nearest, _ = kernel_ops.kmeans_assign(positions, state.centroids)
    else:
        nearest = cl.assign(positions, state.centroids)
    in_region = nearest == state.assignment
    participating = torch.ones_like(in_region)

    params, losses = _local_train(state.params, imgs, labs, lr=cfg.lr,
                                  steps=cfg.local_steps,
                                  microbatch=cfg.client_microbatch)
    params = agg.hierarchical_round(
        params, losses, data.data_sizes, state.assignment, k, participating,
        do_global=do_global, loss_weighted=strategy.loss_weighted,
        use_kernels=ctx.use_kernels)
    loss_val = losses.mean()

    ps_index_l = state.ps_index.long()
    ps_positions = positions[ps_index_l][state.assignment.long()]
    t_r, e_r = cost_lib.cluster_round_costs(
        positions, ps_positions, state.assignment, participating,
        data.data_sizes, data.freqs, model_bits=ctx.model_bits, lp=ctx.lp,
        cp=ctx.cp)
    if do_global:
        gs = ground_station_position(t_s=state.t_sim)
        t_g, e_g = cost_lib.ground_round_costs(
            positions[ps_index_l], gs, model_bits=ctx.model_bits, lp=ctx.lp)
        t_r, e_r = t_r + t_g, e_r + e_g

    assignment, centroids, ps_index = (state.assignment, state.centroids,
                                       state.ps_index)
    reclustered = 0
    if strategy.reclusters and do_global:
        # re-cluster check (Alg. 1 lines 14-18): the engine's one host read
        d_r = cl.dropout_rate(in_region, state.assignment, k)
        if bool(d_r.max() > cfg.dropout_threshold):
            params, assignment, centroids, ps_index = _recluster(
                ctx, rnd, positions, params, losses, imgs, labs, assignment)
            reclustered = 1

    def global_model():
        return tree_map(lambda x: x.float().mean(0), params)

    return _finish(ctx, state, rnd, params, assignment, centroids, ps_index,
                   reclustered, loss_val, t_r, e_r, int(do_global),
                   global_model)


def _recluster(ctx: _Ctx, rnd: int, positions, params, losses, imgs, labs,
               assignment):
    """k-means on the current geometry, stage-1 under the new layout, the
    §III-C MAML hand-off, and the inherited model for every member whose
    cluster changed."""
    cfg, k, strategy = ctx.cfg, ctx.k, ctx.strategy
    res = cl.kmeans(positions, k, ctx.draws.kmeans_init(rnd))
    new_assignment = res.assignment
    cluster_models = agg.cluster_aggregate(
        params, agg.loss_weights(losses, new_assignment, k),
        new_assignment, k, use_kernels=ctx.use_kernels)
    if strategy.maml:
        cluster_models = _meta_update_clusters(
            cluster_models, new_assignment, imgs, labs, k=k,
            alpha=cfg.maml_alpha, beta=cfg.maml_beta)
    inherited = agg.broadcast_clusters(cluster_models, new_assignment)
    if strategy.maml:
        # joining members take MAML inner steps on their own data from the
        # meta-updated cluster model (§III-C)
        inherited = maml_lib.inner_adapt(lenet_loss, inherited,
                                         (imgs, labs), cfg.maml_alpha)
    changed = new_assignment != assignment
    params = tree_map(
        lambda inh, old: torch.where(
            changed.reshape((-1,) + (1,) * (inh.dim() - 1)), inh, old),
        inherited, params)
    return params, new_assignment, res.centroids, res.ps_index


def central_step(ctx: _Ctx, state: RoundState, rnd: int):
    """One centralized round (c-fedavg): the server trains on raw data."""
    cfg, data = ctx.cfg, ctx.data
    positions = ctx.constellation.positions(state.t_sim)
    model = state.params

    def batch(step):
        picks = ctx.draws.central_picks(rnd, step)
        return data.images[picks], data.labels[picks]

    if cfg.local_steps > 0:
        for s in range(cfg.local_steps):
            loss_val, g = maml_lib.grad_tree(lenet_loss, model, batch(s))
            model = maml_lib.sgd_tree(model, g, cfg.lr)
    else:
        # no training this round: report the current model's loss
        loss_val = lenet_loss(model, batch(0))

    participating = torch.ones((cfg.num_clients,), dtype=torch.bool,
                               device=positions.device)
    server_pos = positions[state.ps_index[:1].long()][0]
    t_r, e_r = cost_lib.cfedavg_round_costs(
        positions, server_pos, participating, data.data_sizes, data.freqs,
        sample_bits=cfg.dataset.img ** 2 * cfg.dataset.channels * 32.0,
        server_freq_hz=ctx.cp.max_freq_hz, lp=ctx.lp, cp=ctx.cp)
    return _finish(ctx, state, rnd, model, state.assignment,
                   state.centroids, state.ps_index, 0, loss_val, t_r, e_r,
                   0, lambda: model)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def simulate(cfg: FLRunConfig, seed: Optional[int] = None, *, device=None,
             state0: Optional[RoundState] = None,
             data: Optional[SimData] = None,
             draws: Any = None) -> Tuple[RoundState, RoundOutput]:
    """Run every round -> (final state, per-round history as numpy).

    Without ``state0``/``data`` the run sets itself up (:func:`setup`);
    without ``draws`` it draws natively (:class:`TorchDraws`).  The
    history is fetched from the device once, after the last round."""
    dev = device_lib.resolve(device)
    strategy = _strategy_for(cfg)
    seed = cfg.seed if seed is None else seed
    if (state0 is None) != (data is None):
        raise ValueError("pass both state0 and data, or neither")
    if state0 is None:
        state0, data = setup(cfg, seed, device=dev)
    if draws is None:
        draws = TorchDraws(cfg, seed, dev)
    n_params = sum(x.numel() for x in tree_leaves(state0.params))
    if not strategy.centralized:
        n_params //= cfg.num_clients
    ctx = _Ctx(cfg=cfg, strategy=strategy, data=data, draws=draws,
               k=_num_clusters(cfg, strategy),
               constellation=_constellation_for(cfg.num_clients),
               model_bits=n_params * 32.0,
               use_kernels=cfg.use_pallas_kernels)
    step = central_step if strategy.centralized else fed_step

    state, rows = state0, []
    for rnd in range(cfg.rounds):
        state, row = step(ctx, state, rnd)
        rows.append(row)
    series = torch.stack([torch.stack([r[i].float() for r in rows])
                          for i in range(4)]).cpu().numpy()  # one fetch
    outs = RoundOutput(
        acc=series[0], loss=series[1], time_s=series[2], energy_j=series[3],
        reclustered=np.asarray([r[4] for r in rows], np.int32),
        evaluated=np.asarray([r[5] for r in rows], bool),
        did_global=np.asarray([r[6] for r in rows], np.int32))
    return state, outs


def history_from_outputs(outs: RoundOutput) -> Dict[str, Any]:
    """Host-side history dict: entries at every ``eval_every``-th round
    (plus the last), the re-cluster and stage-2 totals."""
    idx = np.nonzero(outs.evaluated)[0]
    return {
        "round": [int(i) + 1 for i in idx],
        "acc": [float(outs.acc[i]) for i in idx],
        "loss": [float(outs.loss[i]) for i in idx],
        "time_s": [float(outs.time_s[i]) for i in idx],
        "energy_j": [float(outs.energy_j[i]) for i in idx],
        "reclusters": int(np.sum(outs.reclustered)),
        "global_rounds": int(np.sum(outs.did_global)),
    }


def run(cfg: FLRunConfig, *, device=None) -> Dict[str, Any]:
    """The reference ``engine.run``'s history dict, from one native run."""
    _, outs = simulate(cfg, device=device)
    return history_from_outputs(outs)
