"""The port's async event engine (`repro_torch/core/async_engine.py`) and
staleness schedules, on the CPU.

* Schedules: equal to the reference's at 1e-6, monotone, 1 at tau = 0.
* Parity: handed the reference's setup, draws and contact plan
  (`test_torch_jaxref.bridged`), fedbuff, fedhc-async and fedspace-async
  with partial cohorts meet the reference's ``async_engine.simulate`` at
  the golden bar: ``did_global`` and flushes exact, time and energy rtol
  1e-5, loss rtol 1e-3, accuracy atol 5e-3 (eval_size 256: one test image
  is 0.0039).
* The full-cohort limit (cohort = buffer = C, ``constant``) equals the
  port's sync engine bit for bit, as ``tests/test_async_engine.py`` pins
  it for the reference.
* Supersede, blackout deferral, the factorized-plan raise, the cohort
  pop's tie order and the host reads.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.core import async_engine as jasync
from repro.core import staleness as jstale

from repro_torch import api as tapi
from repro_torch.core import async_engine as tasync
from repro_torch.core import engine as tengine
from repro_torch.core import staleness as tstale
from repro_torch.core import strategies as tstrat
from repro_torch.core.fedhc import FLRunConfig, _local_train
from repro_torch.orbits import contact as tcontact
from repro_torch.tree import tree_leaves, tree_map

from test_torch_jaxref import bridged

# N = 32 is a 4 x 8 constellation whose ISL graph connects and whose GS
# windows open and close over 4-minute rounds (test_torch_connectivity.py)
PARITY_CFG = dict(num_clients=32, num_clusters=3, rounds=16,
                  rounds_per_global=3, eval_every=4, samples_per_client=32,
                  batch_size=16, local_steps=1, eval_size=256,
                  round_minutes=4.0, async_cohort=8, async_buffer=4)
NATIVE_CFG = dict(num_clients=16, num_clusters=3, rounds=12,
                  rounds_per_global=4, eval_every=4, samples_per_client=32,
                  local_steps=1, batch_size=16, eval_size=128)


def _cfg(method, **kw):
    return FLRunConfig(**{**NATIVE_CFG, "method": method, **kw})


def _sync_twin(method: str) -> str:
    """The sync twin of an async strategy (registered once): identical on
    every axis except ``aggregation="sync"``."""
    name = f"{method}-synctwin"
    if name not in tstrat.names():
        tstrat.register(dataclasses.replace(tstrat.get(method), name=name,
                                            aggregation="sync"))
    return name


# ---- staleness schedules --------------------------------------------------


@pytest.mark.parametrize("name", ["constant", "polynomial", "hinge"])
@pytest.mark.parametrize("a,b", [(0.5, 4.0), (1.0, 0.0), (2.5, 10.0)])
def test_staleness_schedules_match_reference(name, a, b):
    tau = np.concatenate([np.arange(40.0), [63.5, 100.0, 1e3]]
                         ).astype(np.float32)
    got = tstale.decay(name, torch.from_numpy(tau), a=a, b=b).numpy()
    want = np.asarray(jstale.decay(name, jnp.asarray(tau), a=a, b=b))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert got[0] == 1.0 and np.all(got > 0) and np.all(got <= 1)
    assert np.all(np.diff(got) <= 0)                        # monotone
    if name == "constant":
        assert np.all(got == 1.0)
    assert tstale.names() == jstale.names()
    assert tstale.decay(name, 0, a=a, b=b).item() == 1.0    # integer tau
    with pytest.raises(KeyError, match="unknown staleness"):
        tstale.decay("nope", tau, a=a, b=b)


# ---- parity with the reference's async engine ------------------------------

PARITY_CASES = {
    "fedbuff": dict(method="fedbuff", staleness="polynomial"),
    "fedhc-async": dict(method="fedhc-async", staleness="hinge",
                        staleness_b=1.0),
    "fedhc-async-mixed": dict(method="fedhc-async", staleness="polynomial",
                              server_lr=0.5),
    # stage-2 deferred by closed windows, uploads gated per client clock
    "fedspace-async": dict(method="fedspace-async",
                           gs_min_elevation_deg=30.0),
    "fedspace-async-sliced": dict(method="fedspace-async",
                                  gs_min_elevation_deg=30.0,
                                  contact_slices=True),
}


@pytest.mark.parametrize("case", list(PARITY_CASES))
def test_async_parity_from_bridged_inputs(case):
    tcfg, state0, data, draws, jcfg = bridged(**PARITY_CFG,
                                              **PARITY_CASES[case])
    assert isinstance(state0, tasync.AsyncState)
    state, outs = tengine.simulate(tcfg, device="cpu", state0=state0,
                                   data=data, draws=draws)
    jstate, jouts = jasync.simulate(jcfg)
    jouts = jax.device_get(jouts)
    np.testing.assert_array_equal(outs.did_global,
                                  np.asarray(jouts.did_global))
    np.testing.assert_array_equal(outs.flushes, np.asarray(jouts.flushes))
    assert state.pending_global == bool(jstate.pending_global)
    np.testing.assert_allclose(outs.time_s, jouts.time_s, rtol=1e-5)
    np.testing.assert_allclose(outs.energy_j, jouts.energy_j, rtol=1e-5)
    np.testing.assert_allclose(outs.mean_tau, jouts.mean_tau, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(outs.loss, jouts.loss, rtol=1e-3, atol=1e-5)
    ev = np.asarray(jouts.evaluated)
    np.testing.assert_array_equal(outs.evaluated, ev)
    np.testing.assert_allclose(outs.acc[ev], np.asarray(jouts.acc)[ev],
                               atol=5e-3)
    np.testing.assert_array_equal(state.v_cluster.numpy(),
                                  np.asarray(jstate.v_cluster))
    h = tasync.history_from_outputs(outs)
    jh = jasync.history_from_outputs(jouts)
    assert (h["flushes"], h["global_rounds"]) == (jh["flushes"],
                                                  jh["global_rounds"])
    assert h["flushes"] > 0
    assert abs(h["mean_staleness"] - jh["mean_staleness"]) <= 1e-5
    if case.startswith("fedhc-async") or case == "fedspace-async":
        assert h["global_rounds"] >= 1
    if case == "fedspace-async":
        # a due stage-2 that found no window: deferred, then fired
        assert np.any(outs.did_global == 0) and h["mean_staleness"] > 0


# ---- the synchronous limit ----------------------------------------------


def test_full_cohort_zero_staleness_is_sync_bit_for_bit():
    """cohort = buffer = C with the constant schedule replays the port's
    sync engine exactly: acc, loss, time, energy and the stage-2 firings
    (the same draws, training, aggregation calls and cost order)."""
    cfg_a = _cfg("fedhc-async", async_cohort=16, async_buffer=16,
                 staleness="constant")
    _, oa = tengine.simulate(cfg_a, device="cpu")          # routes async
    _, os_ = tengine.simulate(_cfg(_sync_twin("fedhc-async")), device="cpu")
    assert isinstance(oa, tasync.AsyncOutput)
    assert os_.did_global.sum() >= 1                       # stage-2 in it
    np.testing.assert_array_equal(oa.acc, os_.acc)
    np.testing.assert_array_equal(oa.loss, os_.loss)
    np.testing.assert_array_equal(oa.time_s, os_.time_s)
    np.testing.assert_array_equal(oa.energy_j, os_.energy_j)
    np.testing.assert_array_equal(oa.did_global, os_.did_global)
    assert oa.flushes.tolist() == [3] * 12 and oa.mean_tau.max() == 0


# ---- event semantics --------------------------------------------------------


def test_supersede_keeps_the_freshest_update():
    """A client popped again before its cluster flushed replaces its
    buffered update with the newer one: client 0, far faster than the
    rest, is popped at events 1 and 2 while the buffer (all 4 members)
    waits; its slot then holds the event-2 model."""
    cfg = _cfg("fedbuff", num_clients=4, rounds=2, async_cohort=1,
               async_buffer=4, round_minutes=0.0, eval_every=2)
    sync_state, data = tengine.setup(cfg, device="cpu")
    data = data._replace(freqs=torch.tensor([1e10, 1e8, 1e8, 1e8]))
    state0, data = tasync._from_sync(cfg, sync_state, data)
    draws = tengine.TorchDraws(cfg, cfg.seed, torch.device("cpu"))
    state, outs = tasync.simulate(cfg, device="cpu", state0=state0,
                                  data=data, draws=draws)
    assert outs.flushes.tolist() == [0, 0]
    np.testing.assert_array_equal(state.clock[1:], state0.clock[1:])
    assert state.contrib_w.tolist() == [1.0, 0.0, 0.0, 0.0]

    def trained_at(event):
        flat = torch.gather(data.client_idx, 1, draws.batch_picks(event))
        base = tree_map(lambda x: x[:1], state0.work_params)
        return _local_train(base, data.images[flat[:1]],
                            data.labels[flat[:1]], lr=cfg.lr,
                            steps=cfg.local_steps)[0]
    first, second = trained_at(0), trained_at(1)
    got = tree_leaves(tree_map(lambda x: x[:1], state.contrib_params))
    assert all(torch.equal(a, b) for a, b in zip(got, tree_leaves(second)))
    assert not all(torch.equal(a, b)
                   for a, b in zip(got, tree_leaves(first)))


def test_blackout_defers_stage2_until_a_window():
    """fedspace-async on a plan with no GS-visible satellite: stage-2 falls
    due and waits (pending to the end, never fired), reading the host once
    an event from then on; the same run with every satellite visible
    fires it."""
    cfg = _cfg("fedspace-async", num_clients=32, rounds=10,
               rounds_per_global=2, async_cohort=32, async_buffer=2,
               round_minutes=4.0)
    state0, data = tasync.setup(cfg, device="cpu")
    plan = data.plan
    dark = data._replace(plan=plan._replace(
        gs_visible=torch.zeros_like(plan.gs_visible)))
    tengine.reset_host_reads()
    state, outs = tasync.simulate(cfg, device="cpu", state0=state0,
                                  data=dark)
    assert outs.did_global.sum() == 0 and state.pending_global
    assert (state.commits >= cfg.rounds_per_global).all()
    # no global ever resets the count: a read on every event from the
    # rounds_per_global-th on
    assert tengine.HOST_READS == {"window": 0, "recluster": 0,
                                  "stage2": cfg.rounds
                                  - cfg.rounds_per_global + 1}
    lit = data._replace(plan=plan._replace(
        gs_visible=torch.ones_like(plan.gs_visible)))
    state, outs = tasync.simulate(cfg, device="cpu", state0=state0,
                                  data=lit)
    assert outs.did_global.sum() >= 1 and not state.pending_global


def test_factorized_plan_refuses_per_client_clock_routing():
    cfg = _cfg("fedspace", num_clients=16)
    sync_state, data = tengine.setup(
        dataclasses.replace(cfg, contact_factorized=True), device="cpu")
    assert isinstance(data.plan, tcontact.FactorizedContactPlan)
    clocks = torch.zeros(16)
    with pytest.raises(NotImplementedError, match="FactorizedContactPlan"):
        tcontact.route_to_ps_per_client(data.plan, clocks,
                                        sync_state.assignment)
    with pytest.raises(ValueError, match="sync-engine-only"):
        tasync.setup(_cfg("fedspace-async", contact_factorized=True),
                     device="cpu")


@pytest.mark.parametrize("seed", range(6))
def test_cohort_pop_breaks_ties_by_the_lower_index(seed):
    """Equal clocks (every client starts from the same t = 0 costs in a
    symmetric layout) pop in the reference's order: ``lax.top_k`` of the
    negated clocks, sorted."""
    g = np.random.default_rng(seed)
    clock = g.integers(0, 4, 40).astype(np.float32)        # many ties
    for cohort in (1, 5, 17, 40):
        ctx = tasync._Ctx(cfg=None, strategy=None, data=None, draws=None,
                          cohort=cohort, buffer=cohort, k=1,
                          constellation=None, model_bits=0.0, one_hot=None,
                          member_count=None, dk=None)
        got = tasync._pop(ctx, torch.from_numpy(clock)).numpy()
        _, idx = jax.lax.top_k(-jnp.asarray(clock), cohort)
        np.testing.assert_array_equal(got, np.sort(np.asarray(idx)))


def test_host_reads_only_where_stage2_could_be_due():
    """fedbuff (K = 1) reads nothing; fedhc-async reads once an event from
    the rounds_per_global-th event after the last global on."""
    tengine.reset_host_reads()
    tengine.run(_cfg("fedbuff", async_cohort=4), device="cpu")
    assert tengine.HOST_READS == {"window": 0, "recluster": 0, "stage2": 0}
    cfg = _cfg("fedhc-async", async_cohort=16, async_buffer=16,
               staleness="constant")
    _, outs = tengine.simulate(cfg, device="cpu")
    # a global every 4 events: reads on events 4, 8, 12 only
    assert outs.did_global.tolist() == [0, 0, 0, 1] * 3
    assert tengine.HOST_READS["stage2"] == 3


@pytest.mark.parametrize("method", ["fedbuff", "fedhc-async",
                                    "fedspace-async"])
def test_async_methods_run_through_api(method, tmp_path):
    """``api.run`` and ``run_fl`` route async strategies to the event
    engine: finite histories, the async totals, and a saved result that
    loads back."""
    from repro_torch.core.fedhc import run_fl
    sc = tapi.Scenario(
        method=method,
        data=tapi.DataSpec(samples_per_client=32, eval_size=64),
        fleet=tapi.FleetSpec(num_clients=32, num_clusters=3,
                             round_minutes=4.0),
        train=tapi.TrainSpec(rounds=12, eval_every=6, local_steps=1,
                             batch_size=8),
        async_=tapi.AsyncSpec(cohort=8, buffer=4))
    res = tapi.run(sc, device="cpu")
    assert res.flushes is not None and res.flushes > 0
    assert res.mean_staleness >= 0 and res.reclusters == 0
    assert res.round.tolist() == [6, 12]
    assert np.all(np.isfinite(res.acc)) and np.all(np.diff(res.time_s) >= 0)
    res.save(tmp_path / "run.json")
    back = tapi.RunResult.load(tmp_path / "run.json")
    assert back.to_history() == res.to_history()
    h = run_fl(sc.to_flat(), device="cpu")
    assert h == res.to_history()
