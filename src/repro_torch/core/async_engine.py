"""Event-driven asynchronous FL engine: FedBuff-style buffered,
staleness-weighted aggregation on one device.

Counterpart of ``repro/core/async_engine.py``.  The reference compiles the
run into one ``lax.scan`` of events; here an event is eager PyTorch and
the run is a Python loop over :func:`_event`.  ``engine.simulate`` and
``engine.run`` route ``aggregation="async-buffered"`` strategies (fedbuff,
fedhc-async, fedspace-async) here.

Each satellite runs on its own virtual clock, advanced by the strategy's
cost model; one event:

1. **Pop** the ``async_cohort`` clients with the smallest clocks.  The
   reference takes ``lax.top_k(-clock)``, which breaks equal clocks by the
   lower index; ``torch.topk`` promises no order among ties, so the port
   takes the first ``cohort`` of a stable ascending sort.  The event time
   is the cohort's latest completion.
2. **Train** the cohort on the models it fetched at its last restart.
   The event's batch picks are ``draws.batch_picks(event)``, full width
   (C, B) as the reference draws them; a partial cohort gathers its rows.
3. **Contribute**: an update lands in its cluster's buffer with weight
   ``s(tau)``, ``tau = v_cluster - v_client`` (`core/staleness.py`); a
   visibility-gated strategy validates the upload against the contact
   plan at the client's own clock.  A client popped again before its
   cluster flushed supersedes its previous update.
4. **Flush** every cluster whose buffer holds ``min(async_buffer, members)``
   updates (`core/aggregation.py::buffered_flush`, whose stage-1 goes
   through the ``weighted_agg_multi`` kernel when ``use_pallas_kernels``
   is on: one launch an event).
5. **Stage-2** (K > 1): once every non-empty cluster has committed
   ``rounds_per_global`` flushes since the last global, or while one is
   pending, the cluster models aggregate globally, if the contact window
   (evaluated at the last event's time) is open.
6. **Restart** the cohort: its clocks advance past the event by the
   inter-round gap plus the next round's cost at the restart time, and it
   fetches its cluster model.

With ``async_cohort = async_buffer = num_clients`` the engine takes a
dedicated full-cohort path (no gather or scatter, the sync cost
reduction), which with the ``constant`` schedule reproduces the sync
engine's trajectory bit for bit (pinned in ``tests/test_torch_async.py``).

Host synchronisation.  Flush masks, versions, staleness and buffer
weights stay on the device (``torch.where``); the eval cadence is
static.  The one host read an event, counted in
``engine.HOST_READS["stage2"]`` and spanned by `engine.host_read`, is
whether stage-2 is due and its window open (one value encoding both),
and it is made only on an event where stage-2 could be due: a cluster
commits at most one flush an event, so none is due before
``rounds_per_global`` events have passed since the last global, unless
one is pending.  Flat fedbuff makes no read.  The history is fetched
once after the last event (``"fetch"``).

Telemetry (``cfg.telemetry``): each event also builds one
``obs.telemetry.Telemetry`` (the reference's step 9): outputs only,
riding the history's one fetch, so :func:`simulate` returns the
``(AsyncOutput, Telemetry)`` pair.

Client mesh (``mesh=``, the sync engine's layout): both client stacks and
the per-client vectors (clocks, durations, pending energies, losses,
``contrib_w``, ``v_client``) are this rank's rows; the cluster models,
versions, commits and decisions are replicated.  A partial-cohort event
gathers the clocks (an ``all_reduce`` into zeros), so every rank pops the
same cohort; it then trains a static ``min(cohort, C/W)`` of its own
rows, its cohort members first, and keeps only theirs (no host read of
how many it holds).  After the contributions one gather carries the
losses, buffer weights, acceptances, staleness and pending costs, so the
flush weights, buffer counts and costs are computed as on one device;
the flush reduces its own rows and ``all_reduce``s the (K, P) partials
(`aggregation_spmd.buffered_flush_sharded`).  The stage-2 read is of
rank 0's value.  At W = 1 the history is the one-device history.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core import aggregation as agg
from repro_torch.core import aggregation_spmd as agg_spmd
from repro_torch.core import engine
from repro_torch.core import staleness as stale_lib
from repro_torch.core import strategies as strat_lib
from repro_torch.core.engine import SimData
from repro_torch.core.fedhc import FLRunConfig, _local_train
from repro_torch.data.synthetic import client_batches
from repro_torch.models.lenet import lenet_accuracy
from repro_torch.obs import telemetry as telem_lib
from repro_torch.orbits import contact as contact_lib
from repro_torch.orbits import cost as cost_lib
from repro_torch.orbits.constellation import (Constellation,
                                              ground_station_position)
from repro_torch.orbits.links import LinkParams
from repro_torch.tree import tree_leaves, tree_map


class AsyncState(NamedTuple):
    """Everything one event mutates."""
    work_params: Any           # (C, ...) model each client trains (its
    #                            last fetch from its cluster PS)
    contrib_params: Any        # (C, ...) last completed update per client,
    #                            buffered until its cluster flushes
    cluster_params: Any        # (K, ...) cluster/server models
    contrib_w: torch.Tensor    # (C,) f32 staleness-decayed buffer weight
    #                            (0 = empty slot)
    losses: torch.Tensor       # (C,) last training loss per client
    clock: torch.Tensor        # (C,) f32 completion time of the round in
    #                            flight (the event queue)
    dur: torch.Tensor          # (C,) f32 duration of the round in flight
    e_pending: torch.Tensor    # (C,) f32 energy of the round in flight
    v_cluster: torch.Tensor    # (K,) int32 cluster model version
    v_client: torch.Tensor     # (C,) int32 version each client fetched
    commits: torch.Tensor      # (K,) int32 flushes since the last global
    assignment: torch.Tensor   # (C,) int32 static cluster id
    ps_index: torch.Tensor     # (K,) int32 static cluster PS satellite
    t_sim: torch.Tensor        # () f32 last event's restart time
    e_sim: torch.Tensor        # () f32 cumulative energy (J)
    pending_global: bool = False   # a due stage-2 waits for a window
    since_global: int = 0      # events since the last global (host count)


class AsyncOutput(NamedTuple):
    """The per-event history (numpy after :func:`simulate`)."""
    acc: Any                   # test accuracy (NaN on non-eval events)
    loss: Any                  # mean of the per-client last-known losses
    time_s: Any                # simulated time after this event
    #                            (non-decreasing, not strictly increasing)
    energy_j: Any              # cumulative energy after this event
    evaluated: Any             # bool: acc is valid this event
    did_global: Any            # 0/1: stage-2 fired this event
    flushes: Any               # cluster buffers flushed this event
    mean_tau: Any              # mean staleness of accepted updates (0.0
    #                            when none were accepted)


def _statics(cfg: FLRunConfig):
    """Resolve and validate the static async knobs of a config:
    ``(strategy, cohort, buffer, k)``."""
    strategy = strat_lib.get(cfg.method)
    if not strategy.is_async:
        raise ValueError(f"{cfg.method!r} is a synchronous strategy; use "
                         f"repro_torch.core.engine (which routes "
                         f"automatically)")
    c = cfg.num_clients
    cohort = cfg.async_cohort if cfg.async_cohort > 0 else c
    if not 1 <= cohort <= c:
        raise ValueError(f"async_cohort={cfg.async_cohort} must be in "
                         f"[1, num_clients={c}]")
    buffer = cfg.async_buffer if cfg.async_buffer > 0 else cohort
    if cfg.staleness not in stale_lib.names():
        raise ValueError(f"unknown staleness schedule {cfg.staleness!r}; "
                         f"registered: {stale_lib.names()}")
    k = 1 if strategy.flat else cfg.num_clusters
    return strategy, cohort, buffer, k


def _member_costs(cfg: FLRunConfig, strategy, plan, assignment, ps_index, t,
                  data_sizes, freqs, constellation: Constellation,
                  model_bits: float, lp: LinkParams,
                  cp: cost_lib.ComputeParams, shard=None):
    """Per-client (duration, energy) of one local round starting at the
    scalar time ``t``: the vectors the sync engine reduces to a makespan,
    so each client's clock can advance on its own (on a client mesh, this
    rank's rows: ``data_sizes``, ``freqs`` and the plan's rows are)."""
    rows = assignment if shard is None else shard.local(assignment)
    if strategy.visibility_gated:
        if isinstance(plan, contact_lib.ClusterContactPlan):
            _, _, tpb_to_ps, _ = contact_lib.lookup_sliced(plan, t)
        else:
            _, _, tpb = contact_lib.lookup(plan, t)
            members = torch.arange(rows.shape[0], device=tpb.device)
            tpb_to_ps = tpb[members, ps_index.long()[rows.long()]]
        return cost_lib.routed_cluster_member_costs(
            tpb_to_ps, torch.isfinite(tpb_to_ps), data_sizes, freqs,
            model_bits=model_bits, lp=lp, cp=cp)
    positions = constellation.positions(t)
    ps_positions = positions[ps_index.long()][rows.long()]
    if shard is not None:
        positions = shard.local(positions)
    return cost_lib.cluster_member_costs(
        positions, ps_positions, data_sizes, freqs, model_bits=model_bits,
        lp=lp, cp=cp)


def _model_bits(work_params, num_clients: int) -> float:
    return sum(x.numel() for x in tree_leaves(work_params)) \
        / num_clients * 32.0


def _from_sync(cfg: FLRunConfig, sync_state, data: SimData, shard=None
               ) -> Tuple[AsyncState, SimData]:
    """The event-queue state on top of the sync setup: every client's
    first round starts at t = 0, so its first clock and energy are the
    t = 0 member costs.  On a client mesh the per-client vectors are this
    rank's rows."""
    strategy, _, _, k = _statics(cfg)
    c = cfg.num_clients if shard is None else shard.rows
    dev = sync_state.t_sim.device
    assignment = sync_state.assignment
    ps_index = sync_state.ps_index[:k]
    # every row of the initial stack is w0: k copies of one row
    cluster_params = tree_map(
        lambda x: x[:1].expand((k,) + x.shape[1:]).clone(),
        sync_state.params)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    dur0, e0 = _member_costs(
        cfg, strategy, data.plan, assignment, ps_index, zero,
        data.data_sizes, data.freqs,
        engine._constellation_for(cfg.num_clients),
        _model_bits(sync_state.params, c), LinkParams(),
        cost_lib.ComputeParams(), shard)
    state0 = AsyncState(
        work_params=sync_state.params, contrib_params=sync_state.params,
        cluster_params=cluster_params,
        contrib_w=torch.zeros((c,), dtype=torch.float32, device=dev),
        losses=torch.ones((c,), dtype=torch.float32, device=dev),
        clock=dur0, dur=dur0, e_pending=e0,
        v_cluster=torch.zeros((k,), dtype=torch.int32, device=dev),
        v_client=torch.zeros((c,), dtype=torch.int32, device=dev),
        commits=torch.zeros((k,), dtype=torch.int32, device=dev),
        assignment=assignment, ps_index=ps_index, t_sim=zero,
        e_sim=zero.clone())
    return state0, data


def setup(cfg: FLRunConfig, seed: Optional[int] = None, *,
          contact_plan=None, device=None, mesh=None,
          client_axes=None) -> Tuple[AsyncState, SimData]:
    """One-time setup on ``device`` (default ``cuda``): ``engine.setup``
    (the same streams, the basis of the sync-equivalence pin), then the
    event queue; on a client ``mesh``, this rank's rows."""
    strategy = _statics(cfg)[0]
    sync_state, data = engine.setup(cfg, seed, contact_plan=contact_plan,
                                    device=device, mesh=mesh,
                                    client_axes=client_axes)
    return _from_sync(cfg, sync_state, data,
                      engine._shard_for(cfg, strategy, mesh, client_axes))


def state_from_numpy(cfg: FLRunConfig, arrays: Dict[str, Any], *,
                     device=None, mesh=None,
                     client_axes=None) -> Tuple[AsyncState, SimData]:
    """Setup from given arrays (``engine.state_from_numpy``'s), then the
    event queue: the parity tests hand it the reference's setup."""
    strategy = _statics(cfg)[0]
    return _from_sync(cfg, *engine.state_from_numpy(
        cfg, arrays, device=device, mesh=mesh, client_axes=client_axes),
        engine._shard_for(cfg, strategy, mesh, client_axes))


@dataclass(frozen=True)
class _Ctx:
    """What every event reads."""
    cfg: FLRunConfig
    strategy: strat_lib.Strategy
    data: SimData
    draws: Any
    cohort: int
    buffer: int
    k: int
    constellation: Constellation
    model_bits: float
    one_hot: torch.Tensor         # (C, K) static membership
    member_count: torch.Tensor    # (K,)
    dk: torch.Tensor              # (K,) cluster data sizes
    lp: LinkParams = LinkParams()
    cp: cost_lib.ComputeParams = cost_lib.ComputeParams()
    shard: Optional[agg_spmd.ClientShard] = None   # client-mesh rows
    sizes_all: Optional[torch.Tensor] = None       # (C,) gathered sizes

    @property
    def full(self) -> bool:
        return self.cohort == self.cfg.num_clients

    def member_costs(self, state: AsyncState, t):
        return _member_costs(self.cfg, self.strategy, self.data.plan,
                             state.assignment, state.ps_index, t,
                             self.data.data_sizes, self.data.freqs,
                             self.constellation, self.model_bits, self.lp,
                             self.cp, self.shard)


def _pop(ctx: _Ctx, clock: torch.Tensor) -> torch.Tensor:
    """The cohort: the ``cohort`` smallest clocks, equal clocks by the
    lower index (a stable ascending sort), in ascending client order."""
    order = torch.sort(clock, stable=True).indices[:ctx.cohort]
    return torch.sort(order).values


def _window(ctx: _Ctx, state: AsyncState):
    """Stage-2 window and costs at the last event's time ``t_sim``:
    ``(window open, t_g, e_g)`` on the device."""
    plan, lp = ctx.data.plan, ctx.lp
    if not ctx.strategy.visibility_gated:
        positions = ctx.constellation.positions(state.t_sim)
        gs = ground_station_position(t_s=state.t_sim)
        t_g, e_g = cost_lib.ground_round_costs(
            positions[state.ps_index.long()], gs,
            model_bits=ctx.model_bits, lp=lp)
        return torch.ones((), dtype=torch.bool, device=t_g.device), t_g, e_g
    if isinstance(plan, contact_lib.ClusterContactPlan):
        gs_vis, gs_dist, _, ps_rows = contact_lib.lookup_sliced(plan,
                                                                state.t_sim)
    else:
        gs_vis, gs_dist, tpb = contact_lib.lookup(plan, state.t_sim)
        ps_rows = (tpb.index_select(0, state.ps_index.long())       # (K,C)
                   if ctx.shard is None
                   else ctx.shard.ps_rows(tpb, state.ps_index))
    score = torch.where(gs_vis, ps_rows.amax(0), torch.inf)        # (C,)
    gateway = score.argmin().reshape(1)
    window = torch.isfinite(score.index_select(0, gateway))[0]
    t_g, e_g = cost_lib.routed_ground_round_costs(
        ps_rows.index_select(1, gateway)[:, 0],
        gs_dist.index_select(0, gateway)[0], model_bits=ctx.model_bits,
        lp=lp)
    return window, t_g, e_g


def _where_rows(mask: torch.Tensor, new: Any, old: Any) -> Any:
    """Per client row: ``new`` where ``mask`` (C,), else ``old``."""
    return tree_map(lambda a, b: torch.where(
        mask.reshape((-1,) + (1,) * (a.dim() - 1)), a, b), new, old)


def _event(ctx: _Ctx, state: AsyncState, step: int):
    cfg, data, strategy, k = ctx.cfg, ctx.data, ctx.strategy, ctx.k
    shard = ctx.shard
    c = cfg.num_clients
    picks = ctx.draws.batch_picks(step)                             # (C,B)
    if shard is not None:
        picks = shard.local(picks)
    n_rows = picks.shape[0]

    # ---- 1-2. pop the earliest-deadline cohort and train it ------------
    # (``*_all`` are (C,) on every rank; without a mesh, the same tensors)
    if ctx.full:
        in_cohort = torch.ones((n_rows,), dtype=torch.bool,
                               device=picks.device)
        in_cohort_all = (in_cohort if shard is None else torch.ones(
            (c,), dtype=torch.bool, device=picks.device))
        imgs, labs = client_batches(data.images, data.labels,
                                    data.client_idx, picks)
        trained, losses = _local_train(
            state.work_params, imgs, labs, lr=cfg.lr, steps=cfg.local_steps,
            microbatch=cfg.client_microbatch,
            client_shards=1 if shard is None else shard.world)
    else:
        clock_all = (state.clock if shard is None
                     else shard.gather(state.clock))
        idx = _pop(ctx, clock_all)
        in_cohort_all = torch.zeros((c,), dtype=torch.bool,
                                    device=picks.device).index_fill_(
                                        0, idx, True)
        t_event = torch.where(in_cohort_all, clock_all, -torch.inf).amax()
        if shard is None:
            in_cohort, rows = in_cohort_all, idx
        else:
            # this rank's cohort members first (ascending), then its other
            # rows: a static min(cohort, C/W) rows to train, whose
            # non-members' results are dropped below
            in_cohort = shard.local(in_cohort_all)
            rows = torch.sort((~in_cohort).to(torch.uint8),
                              stable=True).indices[:min(ctx.cohort, n_rows)]
        flat = torch.gather(data.client_idx, 1, picks.long()).index_select(
            0, rows)
        base = tree_map(lambda x: x.index_select(0, rows), state.work_params)
        trained, l_c = _local_train(base, data.images[flat],
                                    data.labels[flat], lr=cfg.lr,
                                    steps=cfg.local_steps,
                                    microbatch=cfg.client_microbatch)
        losses = state.losses.index_copy(0, rows, l_c)
        if shard is not None:
            losses = torch.where(in_cohort, losses, state.losses)

    # ---- 3. contribute: gated at each client's own clock, decayed -------
    assignment = state.assignment.long()
    a_rows = assignment if shard is None else shard.local(assignment)
    tau = (state.v_cluster.index_select(0, a_rows)
           - state.v_client).float()                                # (C,)
    s = stale_lib.decay(cfg.staleness, tau, a=cfg.staleness_a,
                        b=cfg.staleness_b)
    if strategy.visibility_gated:
        tpb_up = contact_lib.route_to_ps_per_client(
            data.plan, state.clock,
            state.ps_index.long().index_select(0, a_rows))
        ok = in_cohort & torch.isfinite(tpb_up)
    else:
        ok = in_cohort
    contrib_w = torch.where(ok, s, state.contrib_w)
    if ctx.full:
        contrib = _where_rows(ok, trained, state.contrib_params)
    else:
        ok_c = ok.index_select(0, rows)
        contrib = tree_map(
            lambda o, t_: o.index_copy(0, rows, torch.where(
                ok_c.reshape((-1,) + (1,) * (t_.dim() - 1)), t_,
                o.index_select(0, rows))),
            state.contrib_params, trained)
    e_cmp_all = (cost_lib.compute_energy_j(data.data_sizes, data.freqs,
                                           ctx.cp)
                 if cfg.telemetry else None)
    if shard is None:
        losses_all, w_all, ok_all, tau_all = losses, contrib_w, ok, tau
        dur_all, e_pending_all = state.dur, state.e_pending
    else:
        # the event's one gather: what the flush, the counts and the
        # costs read, as (C,) on every rank
        cols = [losses, contrib_w, ok, tau, state.dur, state.e_pending]
        if cfg.telemetry:
            cols.append(e_cmp_all)
        full = shard.gather_vectors(*cols)
        losses_all, w_all, ok_all, tau_all = (full[0], full[1], full[2] > 0,
                                              full[3])
        dur_all, e_pending_all = full[4], full[5]
        if cfg.telemetry:
            e_cmp_all = full[6]
    n_ok = ok_all.float().sum()
    mean_tau = torch.where(ok_all, tau_all, 0.0).sum() / n_ok.clamp_min(1.0)

    # ---- 4. flush full buffers ------------------------------------------
    buf_count = ctx.one_hot.T @ (w_all > 0).float()                 # (K,)
    flush = ((buf_count >= ctx.member_count.clamp_max(float(ctx.buffer)))
             & (ctx.member_count > 0))
    if shard is None:
        cluster_models = agg.buffered_flush(
            contrib, losses, data.data_sizes, state.assignment, k,
            contrib_w, flush, state.cluster_params,
            loss_weighted=strategy.loss_weighted, server_lr=cfg.server_lr,
            use_kernels=cfg.use_pallas_kernels)
    else:
        cluster_models = agg_spmd.buffered_flush_sharded(
            contrib, losses_all, ctx.sizes_all, state.assignment, k, w_all,
            flush, state.cluster_params, shard=shard,
            loss_weighted=strategy.loss_weighted, server_lr=cfg.server_lr,
            use_kernels=cfg.use_pallas_kernels)
    flush_i = flush.int()
    v_cluster = state.v_cluster + flush_i
    commits = state.commits + flush_i
    contrib_w = torch.where(flush.index_select(0, a_rows), 0.0, contrib_w)

    # ---- 5. buffered stage-2 across clusters ----------------------------
    since = state.since_global + 1
    do_global, pending = False, state.pending_global
    t_g = e_g = None
    if k > 1 and (pending or since >= cfg.rounds_per_global):
        active = ctx.member_count > 0
        due = (torch.where(active, commits >= cfg.rounds_per_global,
                           True).all() | pending)
        window, t_g, e_g = _window(ctx, state)
        with engine.host_read("stage2"):              # the event's read
            code = int(agg_spmd.agreed(shard,
                                       due.int() * 2 + window.int()))
        due_b, window_b = code >= 2, bool(code & 1)
        do_global, pending = due_b and window_b, due_b and not window_b
    if do_global:
        cluster_models = agg.broadcast_global(
            agg.global_aggregate(cluster_models, ctx.dk), k)
        v_cluster = v_cluster + 1
        commits = torch.zeros_like(commits)
        since = 0

    # ---- 6. costs, and restart the cohort -------------------------------
    rest = cfg.round_minutes * 60.0
    if ctx.full:
        # the sync engine's reduction and addition order
        t_r = torch.where(in_cohort_all, dur_all, 0.0).max()
        t_restart = state.t_sim + (t_r + t_g if do_global else t_r) + rest
    else:
        # clamped to the last event: a cohort restarting right after a
        # global exchange does not report time backwards
        t_restart = torch.maximum(
            state.t_sim, (t_event + t_g if do_global else t_event) + rest)
    e_event = torch.where(in_cohort_all, e_pending_all, 0.0).sum()
    e_new = state.e_sim + (e_event + e_g if do_global else e_event)
    dur_next, e_next = ctx.member_costs(state, t_restart)
    clock = torch.where(in_cohort, t_restart + dur_next, state.clock)
    dur = torch.where(in_cohort, dur_next, state.dur)
    e_pending = torch.where(in_cohort, e_next, state.e_pending)

    # ---- 7. fetch: the cohort re-syncs to its cluster model -------------
    work = _where_rows(in_cohort,
                       agg.broadcast_clusters(cluster_models, a_rows),
                       state.work_params)
    v_client = torch.where(in_cohort, v_cluster.index_select(0, a_rows),
                           state.v_client)

    # ---- 8. eval and outputs --------------------------------------------
    evaluated = (step + 1) % cfg.eval_every == 0 or step == cfg.rounds - 1
    if evaluated:
        model = (tree_map(lambda x: x.float().mean(0), work)
                 if shard is None else shard.mean_rows(work))
        acc = lenet_accuracy(model, data.test_x, data.test_y)
    else:
        acc = torch.full((), math.nan, device=e_new.device)
    new_state = AsyncState(
        work_params=work, contrib_params=contrib,
        cluster_params=cluster_models, contrib_w=contrib_w, losses=losses,
        clock=clock, dur=dur, e_pending=e_pending, v_cluster=v_cluster,
        v_client=v_client, commits=commits, assignment=state.assignment,
        ps_index=state.ps_index, t_sim=t_restart, e_sim=e_new,
        pending_global=pending, since_global=since)
    row = (acc, losses_all.mean(), t_restart, e_new, flush_i.sum(), mean_tau,
           evaluated, int(do_global))
    if not cfg.telemetry:
        return new_state, row

    # ---- 9. telemetry (outputs only, nothing re-enters the state) -------
    any_ok = n_ok > 0
    stale_min = torch.where(
        any_ok, torch.where(ok_all, tau_all, torch.inf).amin(), 0.0)
    stale_max = torch.where(
        any_ok, torch.where(ok_all, tau_all, -torch.inf).amax(), 0.0)
    # compute energy of the cohort's finished rounds is
    # time-independent, so subtracting it from the event's energy
    # splits compute from comm exactly
    e_cmp = torch.where(in_cohort_all, e_cmp_all, 0.0).sum()
    if strategy.visibility_gated:
        # hop counts at the event time (uploads are gated at each
        # client's own clock; this is the event-anchored view)
        hops_mean, hops_max = engine._hop_stats(
            cfg, ctx.constellation.positions(state.t_sim),
            state.ps_index, state.assignment, ok_all)
    else:
        hops_mean = hops_max = 0.0
    telem = telem_lib.Telemetry(
        cohort_size=ctx.cohort, accepted=n_ok, cluster_fill=buf_count,
        stale_min=stale_min, stale_mean=mean_tau, stale_max=stale_max,
        flushes=flush_i.sum(), did_global=int(do_global),
        reclustered=0, bits_stage1=ctx.model_bits * (n_ok + ctx.cohort),
        bits_stage2=2.0 * ctx.model_bits * k if do_global else 0.0,
        t_round_s=t_restart - state.t_sim, e_compute_j=e_cmp,
        e_comm_j=(e_new - state.e_sim) - e_cmp,
        hops_mean=hops_mean, hops_max=hops_max)
    return new_state, row + (telem,)


def simulate(cfg: FLRunConfig, seed: Optional[int] = None, *, device=None,
             state0: Optional[AsyncState] = None,
             data: Optional[SimData] = None,
             draws: Any = None, mesh=None,
             client_axes=None) -> Tuple[AsyncState, AsyncOutput]:
    """Run every event -> (final state, per-event history as numpy).
    ``cfg.rounds`` counts events (cohort pops).  Without ``state0``/
    ``data`` the run sets itself up; without ``draws`` it draws natively
    (``engine.TorchDraws``).  The history is fetched once, after the last
    event; with ``cfg.telemetry`` that fetch also carries the telemetry
    and the outputs are the pair ``(AsyncOutput, Telemetry)``.  On a
    client ``mesh`` a given ``state0``/``data`` must come from a setup on
    the same mesh."""
    strategy, cohort, buffer, k = _statics(cfg)
    dev = device_lib.resolve(device)
    seed = cfg.seed if seed is None else seed
    if (state0 is None) != (data is None):
        raise ValueError("pass both state0 and data, or neither")
    if state0 is None:
        state0, data = setup(cfg, seed, device=dev, mesh=mesh,
                             client_axes=client_axes)
    if draws is None:
        draws = engine.TorchDraws(cfg, seed, dev)
    shard = engine._shard_for(cfg, strategy, mesh, client_axes)
    rows = cfg.num_clients if shard is None else shard.rows
    engine._check_rows(state0.work_params, rows)
    sizes_all = (data.data_sizes.float() if shard is None
                 else shard.gather(data.data_sizes))
    one_hot = agg.membership_one_hot(state0.assignment, k)          # (C,K)
    ctx = _Ctx(cfg=cfg, strategy=strategy, data=data, draws=draws,
               cohort=cohort, buffer=buffer, k=k,
               constellation=engine._constellation_for(cfg.num_clients),
               model_bits=_model_bits(state0.work_params, rows),
               one_hot=one_hot, member_count=one_hot.sum(0),
               dk=one_hot.T @ sizes_all, shard=shard, sizes_all=sizes_all)

    state, rows = state0, []
    for step in range(cfg.rounds):
        state, row = _event(ctx, state, step)
        rows.append(row)
    series = torch.stack([torch.stack([r[i].float() for r in rows])
                          for i in range(6)])
    with engine.host_read("fetch"):                          # one fetch
        if cfg.telemetry:
            series, telem = telem_lib.fetch(series, [r[8] for r in rows])
        else:
            series = series.cpu().numpy()
    outs = AsyncOutput(
        acc=series[0], loss=series[1], time_s=series[2], energy_j=series[3],
        evaluated=np.asarray([r[6] for r in rows], bool),
        did_global=np.asarray([r[7] for r in rows], np.int32),
        flushes=series[4].astype(np.int32), mean_tau=series[5])
    return state, ((outs, telem) if cfg.telemetry else outs)


def history_from_outputs(outs: AsyncOutput) -> Dict[str, Any]:
    """The sync engine's history dict (`engine.eval_point_lists`) plus the
    async totals: buffer ``flushes`` and the event-averaged
    ``mean_staleness`` of accepted updates."""
    outs, _ = engine.split_outputs(outs)
    outs, history = engine.eval_point_lists(outs)
    history["reclusters"] = 0                # static layout by construction
    history["global_rounds"] = int(np.sum(outs.did_global))
    history["flushes"] = int(np.sum(outs.flushes))
    history["mean_staleness"] = float(np.mean(outs.mean_tau))
    return history


def run(cfg: FLRunConfig, verbose: bool = False, *, device=None,
        mesh=None, client_axes=None) -> Dict[str, Any]:
    """``engine.run``'s history layout (entries at every
    ``eval_every``-th event plus the last) with the async totals."""
    _, outs = simulate(cfg, device=device, mesh=mesh,
                       client_axes=client_axes)
    history = history_from_outputs(outs)
    if verbose:
        engine._print_history(history, f"{cfg.method} async", "event")
    return history
