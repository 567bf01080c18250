"""Sync FedHC round engine on one device.

Counterpart of the single-device path of ``repro/core/engine.py``.  The
reference compiles the whole run into one ``lax.scan``; here a round is
eager PyTorch and the run is a Python loop over :func:`fed_step` (or
:func:`central_step` for c-fedavg).

Time-varying connectivity (``Strategy.connectivity != "always"``:
fedspace, isl-onboard) rides on a contact plan (`orbits/contact.py`)
that :func:`setup` builds once on the run's device.  Each round gathers
from it by the simulated clock: a member takes part when an ISL route to
its PS exists, uploads cost the route's seconds-per-bit, and a due
stage-2 that finds no window (no GS-visible gateway every PS can reach,
or for isl-onboard a PS pair with no route) sets ``pending_global`` and
is retried every round until one opens.

Host synchronisation.  Everything a round computes stays on the device,
except these reads (each counted in :data:`HOST_READS` and spanned
``host_read/<reason>`` by :func:`host_read`):

* ``"window"``: on a round where a visibility-gated method's stage-2 is
  due (on cadence, or while ``pending_global`` is set), whether the
  window is open: ``do_global`` then decides which aggregation runs.
  ``pending_global`` is a Python bool derived from these reads.
* ``"recluster"``: on a stage-2 round of a re-clustering method (fedhc,
  fedhc-nomaml), ``max(dropout rate) > Z``, which guards k-means and the
  MAML hand-off (the reference's ``lax.cond``).

Otherwise ``do_global`` and ``evaluated`` depend only on the round
index, so they are Python values, and the history is fetched once after
the last round (``"fetch"``).  So a run makes one read per due round of
a gated method, ``rounds // rounds_per_global`` for fedhc/fedhc-nomaml
and none for h-base, fedce and c-fedavg, plus the final fetch.  (CUDA
graphs, which would also remove the per-kernel launch cost, come
later.)

Randomness goes through a *draws* object with three methods:
``batch_picks(rnd) -> (C, B)``, ``kmeans_init(rnd) -> (K,)`` and
``central_picks(rnd, step) -> (B,)``.  :class:`TorchDraws` draws from a
``torch.Generator`` on the run's device, re-seeded per call from
``(seed, stream, round, step)`` so a draw does not depend on which draws
came before it (the reference's ``fold_in``).  :class:`ArrayDraws`
replays given arrays: the parity tests hand it the reference's draws.

Async strategies (fedbuff, fedhc-async, fedspace-async) run on the
event engine, `core/async_engine.py`: :func:`simulate` and :func:`run`
route them there, as the reference's do.  :func:`run_many_seeds` is the
seed sweep: one contact plan built once and shared, then a loop over
seeds, each seed the run ``simulate`` gives on that seed (the reference
vmaps its scan over a stacked seed axis; a stacked axis here is speed
work, ROADMAP queue 2).  Contact-plan builds and reuses are counted in
``obs.trace.COUNTERS`` (``engine.plan_cache.miss/hit``).

Telemetry (``cfg.telemetry``, `obs/telemetry.py`): each round also builds
one :class:`~repro_torch.obs.telemetry.Telemetry` from the round's
intermediates, under the ``fed_step/telemetry`` span; nothing of it
re-enters the round state, it draws nothing, reads nothing on the host,
and it rides the history's one fetch: :func:`simulate` then returns the
reference's ``(RoundOutput, Telemetry)`` pair, which :func:`split_outputs`
separates.  Telemetry off runs the rounds without it.

Spans (`obs/trace.phase_scope`, open only while a ``torch.profiler``
capture runs, telemetry on or off): a round's ``fed_step/local_train``,
``fed_step/aggregate`` (stages 1 and 2), ``fed_step/recluster``
(k-means, the cluster aggregation, the MAML hand-off and the
inheritance), ``fed_step/eval`` and ``fed_step/telemetry``, side by
side, and ``host_read/<reason>`` around each host read.

Client mesh (``mesh=``/``client_axes=`` on :func:`setup`,
:func:`simulate`, :func:`run`; `launch/mesh.py`): one process a rank,
each holding rows ``[r*C/W, (r+1)*C/W)`` of the client stack, of
``client_idx``, ``data_sizes`` and ``freqs``, and of a full contact
plan's ``isl_tpb`` (`aggregation_spmd.ClientShard`); no rank builds the
full (C, ...) stack.  Positions, the drift check, k-means, the data pool,
``gs_visible``/``gs_dist_km`` and the decisions are replicated.  A round
makes one gather (an ``all_reduce`` into zeros) of the rows' losses,
participation and member costs, so every rank computes the stage-1
weights, the loss and the Eq. 7-10 reductions in the one-device order;
stage 1 reduces its own rows and ``all_reduce``s the (K, P) partials
(`aggregation_spmd.hierarchical_round_sharded`).  A gated round gathers
the K PS rows of ``isl_tpb`` when its stage-2 is due.  Each host read is
of a value rank 0 broadcasts first, so the ranks take the same branch.
The history and telemetry are replicated, so each rank fetches its own
copy once.  At W = 1 the history is the one-device history bit for bit.
c-fedavg (``shardable`` False) runs replicated on every rank, as in the
reference.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import device as device_lib
from repro_torch.core import aggregation as agg
from repro_torch.core import aggregation_spmd as agg_spmd
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
from repro_torch.obs import telemetry as telem_lib
from repro_torch.obs.trace import COUNTERS, phase_scope
from repro_torch.orbits import contact as contact_lib
from repro_torch.orbits import cost as cost_lib
from repro_torch.orbits import topology as topo_lib
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
    pending_global: bool = False  # a due stage-2 waits for a contact
    #                               window (always False when always-up)


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
    plan: Any = None           # contact plan (None when always-up)


# host reads the round loop makes, by reason (see the module docstring;
# "stage2" is the async engine's, `core/async_engine.py`; "fetch" the
# history's one fetch after a run, both engines')
HOST_READS: Dict[str, int] = {"window": 0, "recluster": 0, "stage2": 0,
                              "fetch": 0}


def reset_host_reads() -> None:
    for key in HOST_READS:
        HOST_READS[key] = 0


def host_read(reason: str):
    """Count one read of the device by the host under ``reason`` and
    return the ``host_read/<reason>`` span to hold around it: the counter
    and the span stand at the same boundary."""
    HOST_READS[reason] += 1
    return phase_scope(f"host_read/{reason}")


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
    """Native per-round draws from a generator on the run's device.  The
    async engine takes an event's picks from ``batch_picks(event)``: the
    reference draws them with the same expression (``randint`` of shape
    (C, B) from the loop key folded with the index), full cohort or
    partial."""

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


def _constellation_for(num_clients: int) -> Constellation:
    planes = int(math.sqrt(num_clients))
    while num_clients % planes:
        planes -= 1
    return Constellation(num_planes=planes,
                         sats_per_plane=num_clients // planes)


def _plan_for(cfg: FLRunConfig, strategy: strat_lib.Strategy,
              cluster_slices=None, *, device=None):
    """The contact plan a config needs, on ``device``; None for always-up
    strategies.  ``cluster_slices=(assignment, ps_index)`` builds the
    sliced (``contact_slices``) or factorized (``contact_factorized``)
    form on that static layout."""
    if not strategy.visibility_gated:
        return None
    if cluster_slices is not None and strategy.reclusters:
        raise ValueError("contact_slices/contact_factorized require a "
                         "static cluster layout (recluster='never'): the "
                         "plan only covers the build-time PS set")
    COUNTERS.inc("engine.plan_cache.miss")
    geometry = dict(dt_s=cfg.contact_dt_s,
                    min_elevation_deg=cfg.gs_min_elevation_deg,
                    max_range_km=cfg.isl_max_range_km,
                    max_hops=cfg.isl_max_hops,
                    cluster_slices=cluster_slices, device=device)
    constellation = _constellation_for(cfg.num_clients)
    if cfg.contact_factorized:
        if strategy.is_async:
            raise ValueError(
                "contact_factorized=True is sync-engine-only: the async "
                "engine looks routes up at per-client clocks, which would "
                "recompute the relaxation once per client (store the plan "
                "instead: contact_slices=True)")
        if cfg.contact_slices:
            raise ValueError("contact_slices and contact_factorized are "
                             "mutually exclusive storage layouts")
        return contact_lib.build_factorized_plan(constellation, LinkParams(),
                                                 **geometry)
    return contact_lib.build_contact_plan(
        constellation, LinkParams(),
        storage_dtype=getattr(torch, cfg.contact_dtype), **geometry)


def _initial_plan(cfg, strategy, assignment0, ps_index0, device):
    """The plan :func:`setup` builds: sliced or factorized on the initial
    layout when the config asks for it."""
    slices = ((assignment0, ps_index0)
              if (cfg.contact_slices or cfg.contact_factorized) else None)
    return _plan_for(cfg, strategy, cluster_slices=slices, device=device)


def _num_clusters(cfg: FLRunConfig, strategy: strat_lib.Strategy) -> int:
    return 1 if strategy.centralized else cfg.num_clusters


def _initial_state(cfg, strategy, w0, assignment0, centroids0, ps_index0,
                   device, shard=None) -> RoundState:
    """The round-0 state; on a client mesh the stack is only this rank's
    rows, broadcast from ``w0`` (the full stack is never built)."""
    rows = cfg.num_clients if shard is None else shard.rows
    params0 = (w0 if strategy.centralized
               else agg.broadcast_global(w0, rows))
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return RoundState(params0, assignment0.to(torch.int32),
                      centroids0.float(), ps_index0.to(torch.int32),
                      zero, zero.clone(), 0)


def _shard_for(cfg: FLRunConfig, strategy: strat_lib.Strategy, mesh,
               client_axes) -> Optional[agg_spmd.ClientShard]:
    """This rank's rows on ``mesh``; None without a mesh, and for a
    strategy whose state is replicated (c-fedavg)."""
    if mesh is None or not strategy.shardable:
        return None
    return agg_spmd.client_shard(mesh, cfg.num_clients, client_axes)


def _shard_plan(plan, shard):
    """A plan's per-client rows for this rank: a full plan's ``isl_tpb``
    and a sliced plan's ``tpb_to_ps``; ``gs_visible``, ``gs_dist_km``, the
    sliced PS rows and a factorized plan's generator inputs stay
    replicated."""
    if isinstance(plan, contact_lib.ContactPlan):
        return plan._replace(
            isl_tpb=plan.isl_tpb[:, shard.lo:shard.hi].contiguous())
    if isinstance(plan, contact_lib.ClusterContactPlan):
        return plan._replace(
            tpb_to_ps=plan.tpb_to_ps[:, shard.lo:shard.hi].contiguous())
    return plan


def _shard_data(data: SimData, shard) -> SimData:
    """This rank's rows of the per-client ``SimData`` tensors and plan."""
    if shard is None:
        return data
    return data._replace(
        client_idx=shard.local(data.client_idx),
        data_sizes=shard.local(data.data_sizes),
        freqs=shard.local(data.freqs),
        plan=(_shard_plan(data.plan, shard) if data.plan is not None
              else None))


def setup(cfg: FLRunConfig, seed: Optional[int] = None, *,
          contact_plan=None, device=None, mesh=None,
          client_axes=None) -> Tuple[RoundState, SimData]:
    """One-time experiment setup on ``device`` (default ``cuda``):
    synthetic data, model init, the strategy's initial clustering and PS
    selection, all drawn from generators on the device, and the contact
    plan of a visibility-gated strategy (``contact_plan`` passes a
    prebuilt one instead).  On a client ``mesh`` every rank draws the
    same values and keeps its own rows (module docstring)."""
    dev = device_lib.resolve(device)
    strategy = strat_lib.get(cfg.method)
    shard = _shard_for(cfg, strategy, mesh, client_axes)
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
    state0 = _initial_state(cfg, strategy, w0, assignment0, centroids0,
                            ps_index0, dev, shard)
    if contact_plan is not None and strategy.visibility_gated:
        COUNTERS.inc("engine.plan_cache.hit")
    plan = (contact_plan if contact_plan is not None else _initial_plan(
        cfg, strategy, state0.assignment, state0.ps_index, dev))
    return state0, _shard_data(SimData(images, labels, test_x, test_y,
                                       client_idx, data_sizes, freqs, plan),
                               shard)


def state_from_numpy(cfg: FLRunConfig, arrays: Dict[str, Any], *,
                     device=None, mesh=None,
                     client_axes=None) -> Tuple[RoundState, SimData]:
    """Setup from given arrays instead of draws: ``images``, ``labels``,
    ``test_x``, ``test_y``, ``client_idx``, ``w0`` (the LeNet param tree),
    ``freqs``, ``assignment0``, ``centroids0`` and ``ps_index0``, as numpy
    (e.g. fetched from the JAX package's ``engine.setup``), and optionally
    ``plan`` (`orbits/contact.plan_from_numpy`'s input).  Without a
    ``plan`` a visibility-gated strategy builds its own.  On a client
    ``mesh`` each rank keeps its own rows, as :func:`setup` does."""
    dev = device_lib.resolve(device)
    strategy = strat_lib.get(cfg.method)
    shard = _shard_for(cfg, strategy, mesh, client_axes)

    def t(name, dtype):
        return torch.as_tensor(np.asarray(arrays[name]), device=dev).to(dtype)

    state = _initial_state(cfg, strategy, from_numpy(arrays["w0"], dev),
                           t("assignment0", torch.int32),
                           t("centroids0", torch.float32),
                           t("ps_index0", torch.int32), dev, shard)
    plan = (contact_lib.plan_from_numpy(arrays["plan"], device=dev)
            if arrays.get("plan") is not None else _initial_plan(
                cfg, strategy, state.assignment, state.ps_index, dev))
    data = SimData(t("images", torch.float32), t("labels", torch.int64),
                   t("test_x", torch.float32), t("test_y", torch.int64),
                   t("client_idx", torch.int64),
                   torch.full((cfg.num_clients,),
                              float(cfg.samples_per_client), device=dev),
                   t("freqs", torch.float32), plan)
    return state, _shard_data(data, shard)


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
    telemetry: bool = False
    lp: LinkParams = LinkParams()
    cp: cost_lib.ComputeParams = cost_lib.ComputeParams()
    shard: Optional[agg_spmd.ClientShard] = None   # this rank's rows on a
    #                                                client mesh
    sizes_all: Optional[torch.Tensor] = None       # (C,) data sizes, the
    #                                                mesh's gathered copy


def _finish(ctx: _Ctx, state: RoundState, rnd: int, params, assignment,
            centroids, ps_index, reclustered: int, loss_val, t_r, e_r,
            did_global: int, global_model,
            pending_global: bool = False,
            telem=None) -> Tuple[RoundState, tuple]:
    cfg = ctx.cfg
    t_new = state.t_sim + t_r + cfg.round_minutes * 60.0
    e_new = state.e_sim + e_r
    evaluated = (rnd + 1) % cfg.eval_every == 0 or rnd == cfg.rounds - 1
    if evaluated:
        with phase_scope("fed_step/eval"):
            acc = lenet_accuracy(global_model(), ctx.data.test_x,
                                 ctx.data.test_y)
    else:
        acc = torch.full((), math.nan, device=t_new.device)
    new_state = RoundState(params, assignment, centroids, ps_index, t_new,
                           e_new, state.reclusters + reclustered,
                           pending_global)
    return new_state, (acc, loss_val, t_new, e_new, reclustered, evaluated,
                       did_global, telem)


class _Links(NamedTuple):
    """One round's contact-plan gathers, and its stage-2 (None unless a
    stage-2 is due)."""
    participating: torch.Tensor   # (C,) bool: a route to the PS exists
    tpb_to_ps: torch.Tensor       # (C,) member -> PS route s/bit
    stage2: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]
    #                               (window open, t_g, e_g) on the device


def _gated_links(ctx: _Ctx, state: RoundState, due: bool) -> _Links:
    """Who can route to whom at ``state.t_sim``, and, on a due round, the
    stage-2 window and cost: the relay gateway for fedspace (the
    GS-visible satellite minimizing the worst PS route; ``argmin`` takes
    the first minimum, as the reference's does, all-inf rows included),
    all-pairs PS consensus for isl-onboard.  A sliced or factorized plan
    was built on the initial layout; a full one gathers with the current
    ``ps_index``."""
    plan, shard = ctx.data.plan, ctx.shard
    if isinstance(plan, (contact_lib.ClusterContactPlan,
                         contact_lib.FactorizedContactPlan)):
        gs_vis, gs_dist, tpb_to_ps, ps_rows = contact_lib.lookup_sliced(
            plan, state.t_sim)
        if shard is not None and isinstance(
                plan, contact_lib.FactorizedContactPlan):
            tpb_to_ps = shard.local(tpb_to_ps)   # recomputed for all C
    else:
        gs_vis, gs_dist, tpb = contact_lib.lookup(plan, state.t_sim)
        rows = (state.assignment if shard is None
                else shard.local(state.assignment))
        ps_of_member = state.ps_index.long()[rows.long()]
        members = torch.arange(rows.shape[0], device=tpb.device)
        tpb_to_ps = tpb[members, ps_of_member]
        # (K,C); on a mesh the PS rows live on their owners' ranks
        ps_rows = tpb[state.ps_index.long()] if shard is None else None
    # the PS itself always takes part: the route table's diagonal is 0
    participating = torch.isfinite(tpb_to_ps)
    if not due:
        return _Links(participating, tpb_to_ps, None)
    if ps_rows is None:
        ps_rows = shard.ps_rows(tpb, state.ps_index)
    if ctx.strategy.isl_global:
        # on-board consensus: needs every PS pair connected
        ps_tpb = ps_rows[:, state.ps_index.long()]                  # (K,K)
        window = torch.isfinite(ps_tpb).all()
        t_g, e_g = cost_lib.isl_consensus_costs(
            ps_tpb, model_bits=ctx.model_bits, lp=ctx.lp)
    else:
        score = torch.where(gs_vis, ps_rows.amax(0), torch.inf)    # (C,)
        gateway = score.argmin().reshape(1)
        window = torch.isfinite(score.index_select(0, gateway))[0]
        t_g, e_g = cost_lib.routed_ground_round_costs(
            ps_rows.index_select(1, gateway)[:, 0],
            gs_dist.index_select(0, gateway)[0],
            model_bits=ctx.model_bits, lp=ctx.lp)
    return _Links(participating, tpb_to_ps, (window, t_g, e_g))


def fed_step(ctx: _Ctx, state: RoundState, rnd: int):
    """One federated round (fedhc / fedhc-nomaml / h-base / fedce /
    fedspace / isl-onboard).  On a client mesh ``state.params`` and the
    batches are this rank's rows (module docstring)."""
    cfg, data, strategy, k = ctx.cfg, ctx.data, ctx.strategy, ctx.k
    shard = ctx.shard
    positions = ctx.constellation.positions(state.t_sim)
    cadence_due = (rnd + 1) % cfg.rounds_per_global == 0

    picks = ctx.draws.batch_picks(rnd)
    if shard is not None:
        picks = shard.local(picks)
    imgs, labs = client_batches(data.images, data.labels, data.client_idx,
                                picks)

    # geometry drift: a satellite whose nearest centroid changed has
    # "left" its cluster (Alg. 1) -- drives the dropout rate
    if ctx.use_kernels:
        nearest, _ = kernel_ops.kmeans_assign(positions, state.centroids)
    else:
        nearest = cl.assign(positions, state.centroids)
    in_region = nearest == state.assignment
    links = None
    if strategy.visibility_gated:
        links = _gated_links(ctx, state, cadence_due or state.pending_global)
        participating = links.participating
    else:
        participating = torch.ones_like(
            in_region if shard is None else shard.local(in_region))

    with phase_scope("fed_step/local_train"):
        params, losses = _local_train(
            state.params, imgs, labs, lr=cfg.lr, steps=cfg.local_steps,
            microbatch=cfg.client_microbatch,
            client_shards=1 if shard is None else shard.world)
    pending_global = False
    if links is None:
        do_global = cadence_due
    elif links.stage2 is None:
        do_global = False
    else:
        # the round's one host read, after training was queued so the
        # device has work while the host waits
        with host_read("window"):
            do_global = bool(agg_spmd.agreed(ctx.shard, links.stage2[0]))
        pending_global = not do_global
    e_cmp = None
    if shard is not None:
        # every rank now holds the full losses and participation, and
        # reduces the member costs in the one-device order
        losses, participating, t_r, e_r, e_cmp = _gather_round(
            ctx, positions, state, links, participating, losses)
    with phase_scope("fed_step/aggregate"):
        if shard is None:
            params = agg.hierarchical_round(
                params, losses, data.data_sizes, state.assignment, k,
                participating, do_global=do_global,
                loss_weighted=strategy.loss_weighted,
                use_kernels=ctx.use_kernels)
        else:
            params = agg_spmd.hierarchical_round_sharded(
                params, losses, ctx.sizes_all, state.assignment, k,
                do_global, shard=shard, participating=participating,
                loss_weighted=strategy.loss_weighted,
                use_kernels=ctx.use_kernels)
    loss_val = losses.mean()

    ps_index_l = state.ps_index.long()
    if links is not None:
        if shard is None:
            t_r, e_r = cost_lib.routed_cluster_round_costs(
                links.tpb_to_ps, participating, data.data_sizes, data.freqs,
                model_bits=ctx.model_bits, lp=ctx.lp, cp=ctx.cp)
        if do_global:
            t_r, e_r = t_r + links.stage2[1], e_r + links.stage2[2]
    else:
        if shard is None:
            ps_positions = positions[ps_index_l][state.assignment.long()]
            t_r, e_r = cost_lib.cluster_round_costs(
                positions, ps_positions, state.assignment, participating,
                data.data_sizes, data.freqs, model_bits=ctx.model_bits,
                lp=ctx.lp, cp=ctx.cp)
        if do_global:
            gs = ground_station_position(t_s=state.t_sim)
            t_g, e_g = cost_lib.ground_round_costs(
                positions[ps_index_l], gs, model_bits=ctx.model_bits,
                lp=ctx.lp)
            t_r, e_r = t_r + t_g, e_r + e_g

    assignment, centroids, ps_index = (state.assignment, state.centroids,
                                       state.ps_index)
    reclustered = 0
    if strategy.reclusters and do_global:
        # re-cluster check (Alg. 1 lines 14-18): a host read
        d_r = cl.dropout_rate(in_region, state.assignment, k)
        with host_read("recluster"):
            due = bool(agg_spmd.agreed(ctx.shard,
                                       d_r.max() > cfg.dropout_threshold))
        if due:
            with phase_scope("fed_step/recluster"):
                params, assignment, centroids, ps_index = _recluster(
                    ctx, rnd, positions, params, losses, imgs, labs,
                    assignment)
            reclustered = 1

    telem = None
    if ctx.telemetry:
        with phase_scope("fed_step/telemetry"):
            telem = _fed_telemetry(ctx, state, positions, participating,
                                   assignment, do_global, reclustered, t_r,
                                   e_r, e_cmp)

    if shard is None:
        def global_model():
            return tree_map(lambda x: x.float().mean(0), params)
    else:
        def global_model():
            return shard.mean_rows(params)

    return _finish(ctx, state, rnd, params, assignment, centroids, ps_index,
                   reclustered, loss_val, t_r, e_r, int(do_global),
                   global_model, pending_global, telem=telem)


def _gather_round(ctx: _Ctx, positions, state: RoundState, links,
                  participating, losses):
    """A client-mesh round's one gather: this rank's losses,
    participation and member costs (and compute energies, for telemetry)
    into full (C,) vectors on every rank.  Returns ``(losses,
    participating, t_r, e_r, e_cmp)``, the stage-1 costs reduced as one
    device reduces them (``e_cmp`` None without telemetry)."""
    data, shard = ctx.data, ctx.shard
    if links is not None:
        t_i, e_i = cost_lib.routed_cluster_member_costs(
            links.tpb_to_ps, participating, data.data_sizes, data.freqs,
            model_bits=ctx.model_bits, lp=ctx.lp, cp=ctx.cp)
    else:
        rows = shard.local(state.assignment).long()
        ps_positions = positions[state.ps_index.long()][rows]
        t_i, e_i = cost_lib.cluster_member_costs(
            shard.local(positions), ps_positions, data.data_sizes,
            data.freqs, model_bits=ctx.model_bits, lp=ctx.lp, cp=ctx.cp)
    cols = [losses, participating, t_i, e_i]
    if ctx.telemetry:
        cols.append(cost_lib.compute_energy_j(data.data_sizes, data.freqs,
                                              ctx.cp))
    full = shard.gather_vectors(*cols)
    part = full[1] > 0
    t_r, e_r = cost_lib.round_of_members(full[2], full[3], part)
    e_cmp = (part.float() * full[4]).sum() if ctx.telemetry else None
    return full[0], part, t_r, e_r, e_cmp


def _hop_stats(cfg: FLRunConfig, positions, ps_index, assignment, accepted):
    """``(mean, max)`` member->PS ISL hop count over the ``accepted``
    members with a route at ``positions`` (0 where none has one)."""
    hrows = topo_lib.hop_rows(
        topo_lib.isl_adjacency(positions, cfg.isl_max_range_km), ps_index,
        cfg.isl_max_hops)                                           # (K,C)
    members = torch.arange(cfg.num_clients, device=positions.device)
    hops = hrows[assignment.long(), members]
    routed = accepted & torch.isfinite(hops)
    hops = torch.where(routed, hops, 0.0)
    return hops.sum() / routed.float().sum().clamp_min(1.0), hops.amax()


def _fed_telemetry(ctx: _Ctx, state: RoundState, positions, participating,
                   assignment, do_global: bool, reclustered: int, t_r, e_r,
                   e_cmp=None) -> telem_lib.Telemetry:
    """One federated round's telemetry (the reference's
    ``fed_step/telemetry`` block): outputs only.  ``cluster_fill`` counts
    members under the layout after a re-cluster; the hop counts use the
    round's start layout, the one the uploads took.  On a client mesh
    ``participating`` is the gathered (C,) vector and ``e_cmp`` the
    compute energy the gather summed, so every series is replicated."""
    cfg, k, model_bits = ctx.cfg, ctx.k, ctx.model_bits
    part_f = participating.float()
    n_part = part_f.sum()
    if e_cmp is None:
        e_cmp = (part_f * cost_lib.compute_energy_j(
            ctx.data.data_sizes, ctx.data.freqs, ctx.cp)).sum()
    per_global = (model_bits * k * (k - 1) if ctx.strategy.isl_global
                  else 2.0 * model_bits * k)
    if ctx.strategy.visibility_gated:
        hops_mean, hops_max = _hop_stats(cfg, positions, state.ps_index,
                                         state.assignment, participating)
    else:
        hops_mean = hops_max = 0.0
    return telem_lib.Telemetry(
        cohort_size=cfg.num_clients, accepted=n_part,
        cluster_fill=agg.membership_one_hot(assignment, k).sum(0),
        stale_min=0.0, stale_mean=0.0, stale_max=0.0, flushes=k,
        did_global=int(do_global), reclustered=reclustered,
        bits_stage1=2.0 * model_bits * n_part,
        bits_stage2=per_global if do_global else 0.0,
        t_round_s=t_r + cfg.round_minutes * 60.0,
        e_compute_j=e_cmp, e_comm_j=e_r - e_cmp,
        hops_mean=hops_mean, hops_max=hops_max)


def _recluster(ctx: _Ctx, rnd: int, positions, params, losses, imgs, labs,
               assignment):
    """k-means on the current geometry, stage-1 under the new layout, the
    §III-C MAML hand-off, and the inherited model for every member whose
    cluster changed."""
    cfg, k, strategy, shard = ctx.cfg, ctx.k, ctx.strategy, ctx.shard
    res = cl.kmeans(positions, k, ctx.draws.kmeans_init(rnd))
    new_assignment = res.assignment
    weights = agg.loss_weights(losses, new_assignment, k)
    if shard is None:
        cluster_models = agg.cluster_aggregate(
            params, weights, new_assignment, k, use_kernels=ctx.use_kernels)
        rows_new, rows_old, reduce = new_assignment, assignment, None
    else:
        # the (C,) losses and layouts are full, the stack and batches
        # this rank's rows
        cluster_models = agg_spmd.cluster_aggregate_sharded(
            params, weights, new_assignment, k, shard,
            use_kernels=ctx.use_kernels)
        rows_new, rows_old = (shard.local(new_assignment),
                              shard.local(assignment))
        reduce = shard.sum_tree
    if strategy.maml:
        cluster_models = _meta_update_clusters(
            cluster_models, rows_new, imgs, labs, k=k,
            alpha=cfg.maml_alpha, beta=cfg.maml_beta, reduce=reduce)
    inherited = agg.broadcast_clusters(cluster_models, rows_new)
    if strategy.maml:
        # joining members take MAML inner steps on their own data from the
        # meta-updated cluster model (§III-C)
        inherited = maml_lib.inner_adapt(lenet_loss, inherited,
                                         (imgs, labs), cfg.maml_alpha)
    changed = rows_new != rows_old
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
    sample_bits = cfg.dataset.img ** 2 * cfg.dataset.channels * 32.0
    cp = ctx.cp
    t_r, e_r = cost_lib.cfedavg_round_costs(
        positions, server_pos, participating, data.data_sizes, data.freqs,
        sample_bits=sample_bits, server_freq_hz=cp.max_freq_hz, lp=ctx.lp,
        cp=cp)
    telem = None
    if ctx.telemetry:
        # raw-data uplink + central training: stage-1 traffic is the
        # sample upload, compute energy is the server's
        n_samples = data.data_sizes.sum()
        e_train = (cp.eps0 * cp.max_freq_hz
                   * (n_samples * cp.cycles_per_sample / cp.max_freq_hz))
        telem = telem_lib.Telemetry(
            cohort_size=cfg.num_clients, accepted=cfg.num_clients,
            cluster_fill=[float(cfg.num_clients)] * ctx.k,
            stale_min=0.0, stale_mean=0.0, stale_max=0.0, flushes=0,
            did_global=0, reclustered=0,
            bits_stage1=n_samples * sample_bits, bits_stage2=0.0,
            t_round_s=t_r + cfg.round_minutes * 60.0,
            e_compute_j=e_train, e_comm_j=e_r - e_train,
            hops_mean=0.0, hops_max=0.0)
    return _finish(ctx, state, rnd, model, state.assignment,
                   state.centroids, state.ps_index, 0, loss_val, t_r, e_r,
                   0, lambda: model, telem=telem)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def _check_rows(tree: Any, rows: int) -> None:
    """A state handed to a run must hold the rows the run expects: every
    client-stacked leaf ``rows`` long (a mesh's rank holds C/W)."""
    got = {x.shape[0] for x in tree_leaves(tree)}
    if got != {rows}:
        raise ValueError(f"the client stack has {sorted(got)} rows, this "
                         f"run expects {rows}: set it up with the same "
                         f"mesh (setup(..., mesh=mesh))")


def simulate(cfg: FLRunConfig, seed: Optional[int] = None, *, device=None,
             state0: Optional[RoundState] = None,
             data: Optional[SimData] = None,
             draws: Any = None, mesh=None,
             client_axes=None) -> Tuple[RoundState, RoundOutput]:
    """Run every round -> (final state, per-round history as numpy).

    Without ``state0``/``data`` the run sets itself up (:func:`setup`);
    without ``draws`` it draws natively (:class:`TorchDraws`).  The
    history is fetched from the device once, after the last round; with
    ``cfg.telemetry`` that fetch also carries the telemetry and the
    outputs are the pair ``(RoundOutput, Telemetry)``.  On a client
    ``mesh`` a given ``state0``/``data`` must come from a setup on the
    same mesh; every rank returns the same history.  Async strategies
    route to `core/async_engine.simulate` (its ``(AsyncState,
    AsyncOutput)`` types instead)."""
    strategy = strat_lib.get(cfg.method)
    if strategy.is_async:
        from repro_torch.core import async_engine   # it imports this module
        return async_engine.simulate(cfg, seed, device=device, state0=state0,
                                     data=data, draws=draws, mesh=mesh,
                                     client_axes=client_axes)
    dev = device_lib.resolve(device)
    seed = cfg.seed if seed is None else seed
    if (state0 is None) != (data is None):
        raise ValueError("pass both state0 and data, or neither")
    if state0 is None:
        state0, data = setup(cfg, seed, device=dev, mesh=mesh,
                             client_axes=client_axes)
    if draws is None:
        draws = TorchDraws(cfg, seed, dev)
    shard = _shard_for(cfg, strategy, mesh, client_axes)
    n_params = sum(x.numel() for x in tree_leaves(state0.params))
    if not strategy.centralized:
        rows = cfg.num_clients if shard is None else shard.rows
        _check_rows(state0.params, rows)
        n_params //= rows
    ctx = _Ctx(cfg=cfg, strategy=strategy, data=data, draws=draws,
               k=_num_clusters(cfg, strategy),
               constellation=_constellation_for(cfg.num_clients),
               model_bits=n_params * 32.0,
               use_kernels=cfg.use_pallas_kernels, telemetry=cfg.telemetry,
               shard=shard,
               sizes_all=(None if shard is None
                          else shard.gather(data.data_sizes)))
    step = central_step if strategy.centralized else fed_step

    state, rows = state0, []
    for rnd in range(cfg.rounds):
        state, row = step(ctx, state, rnd)
        rows.append(row)
    series = torch.stack([torch.stack([r[i].float() for r in rows])
                          for i in range(4)])
    with host_read("fetch"):                                 # one fetch
        if cfg.telemetry:
            series, telem = telem_lib.fetch(series, [r[7] for r in rows])
        else:
            series = series.cpu().numpy()
    outs = RoundOutput(
        acc=series[0], loss=series[1], time_s=series[2], energy_j=series[3],
        reclustered=np.asarray([r[4] for r in rows], np.int32),
        evaluated=np.asarray([r[5] for r in rows], bool),
        did_global=np.asarray([r[6] for r in rows], np.int32))
    return state, ((outs, telem) if cfg.telemetry else outs)


def split_outputs(outs):
    """``(outputs, telemetry_or_None)``: a telemetry-on run returns an
    ``(outputs, Telemetry)`` pair, a plain tuple, while bare outputs are
    NamedTuples (``_fields``).  Shared with the async engine (whose pair is
    ``(AsyncOutput, Telemetry)``)."""
    if isinstance(outs, tuple) and not hasattr(outs, "_fields"):
        return outs
    return outs, None


def eval_point_lists(outs):
    """``(outs, partial_history)``: the per-eval-point lists of both
    engines (``evaluated``-masked round/acc/loss/time/energy) from
    outputs already on the host; the callers add their own totals."""
    idx = np.nonzero(np.asarray(outs.evaluated))[0]
    return outs, {
        "round": [int(i) + 1 for i in idx],
        "acc": [float(outs.acc[i]) for i in idx],
        "loss": [float(outs.loss[i]) for i in idx],
        "time_s": [float(outs.time_s[i]) for i in idx],
        "energy_j": [float(outs.energy_j[i]) for i in idx],
    }


def history_from_outputs(outs: RoundOutput) -> Dict[str, Any]:
    """Host-side history dict: entries at every ``eval_every``-th round
    (plus the last), the re-cluster and stage-2 totals."""
    outs, _ = split_outputs(outs)
    outs, history = eval_point_lists(outs)
    history["reclusters"] = int(np.sum(outs.reclustered))
    history["global_rounds"] = int(np.sum(outs.did_global))
    return history


def _print_history(history: Dict[str, Any], tag: str, what: str) -> None:
    for r, a, l, t, e in zip(history["round"], history["acc"],
                             history["loss"], history["time_s"],
                             history["energy_j"]):
        print(f"[{tag}] {what} {r:4d} acc={a:.3f} loss={l:.3f} T={t:.0f}s "
              f"E={e:.1f}J")


def run(cfg: FLRunConfig, verbose: bool = False, *, device=None,
        mesh=None, client_axes=None) -> Dict[str, Any]:
    """The reference ``engine.run``'s history dict, from one native run
    (on a client ``mesh``, the same dict on every rank); async strategies
    route to `core/async_engine.run`."""
    if strat_lib.get(cfg.method).is_async:
        from repro_torch.core import async_engine
        return async_engine.run(cfg, verbose=verbose, device=device,
                                mesh=mesh, client_axes=client_axes)
    _, outs = simulate(cfg, device=device, mesh=mesh,
                       client_axes=client_axes)
    history = history_from_outputs(outs)
    if verbose:
        k = 1 if strat_lib.get(cfg.method).centralized else cfg.num_clusters
        _print_history(history, f"{cfg.method} K={k}", "round")
    return history


def run_many_seeds(cfg: FLRunConfig, seeds: Sequence[int], *,
                   device=None) -> Dict[str, np.ndarray]:
    """Multi-seed sweep: the contact plan of a visibility-gated strategy
    is built once and handed to every seed's :func:`setup`; each seed then
    runs through :func:`simulate`, so it is the run that seed gives alone
    and takes only the re-cluster branches it takes (the reference's
    vmapped ``lax.cond`` runs both).  Returns the reference's per-round
    arrays of shape ``(num_seeds, rounds)`` (mask by ``evaluated``) and
    per-seed totals."""
    strategy = strat_lib.get(cfg.method)
    if strategy.is_async:
        raise NotImplementedError(
            "run_many_seeds is sync-only for now; vmap the async engine's "
            "scan directly or loop async_engine.run over seeds")
    if cfg.contact_slices or cfg.contact_factorized:
        raise ValueError(
            "contact_slices/contact_factorized are incompatible with "
            "run_many_seeds: both plan forms are seed-dependent (they "
            "bake in one seed's cluster layout), while the sweep shares "
            "a single plan across the seed axis. Use the full stored "
            "plan for sweeps.")
    dev = device_lib.resolve(device)
    plan = _plan_for(cfg, strategy, device=dev)
    rows = []
    for seed in seeds:
        state0, data = setup(cfg, int(seed), contact_plan=plan, device=dev)
        rows.append(split_outputs(simulate(cfg, int(seed), device=dev,
                                           state0=state0, data=data)[1])[0])
        del state0, data

    def stack(name):
        return np.stack([getattr(o, name) for o in rows])
    return {
        "seeds": np.asarray(list(seeds)),
        "acc": stack("acc"), "loss": stack("loss"),
        "time_s": stack("time_s"), "energy_j": stack("energy_j"),
        "evaluated": stack("evaluated"),
        "reclusters": stack("reclustered").sum(axis=1),
        "global_rounds": stack("did_global").sum(axis=1),
    }
