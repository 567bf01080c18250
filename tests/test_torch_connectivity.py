"""The port's visibility-gated engine (fedspace, isl-onboard) on the CPU.

* Parity: handed the reference's setup, draws and contact plan
  (`test_torch_jaxref.bridged`), the port's ``engine.simulate`` matches
  the reference's: ``did_global``, ``global_rounds`` and the final
  ``pending_global`` exact, time and energy rtol 1e-5, loss rtol 1e-3,
  accuracy atol 5e-3, on full, bf16, sliced and factorized plans.
* Port-native counterparts of ``tests/test_connectivity.py``'s deferral
  pins: blackout, open sky, defer-then-catch-up, isl-onboard without a
  ground station and without links.
* Host reads: one per round on which a gated stage-2 is due, none else.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
from repro.core import engine as jengine

from repro_torch import api as tapi
from repro_torch.core import engine as tengine
from repro_torch.core import strategies as tstrat
from repro_torch.core.fedhc import FLRunConfig
from repro_torch.orbits import contact as tcontact
from repro_torch.orbits import cost as tcost

from test_torch_jaxref import bridged

# N = 32 is a 4 x 8 constellation; 4-minute rounds at a 30 deg mask open
# and close ground-station windows within 12 rounds.  eval_size 256 is the
# golden's (tests/test_connectivity.py): there one test image is 0.0039, so
# the accuracy bar (atol 5e-3) admits a one-image flip from float rounding
# as the reference's own pin does (ROADMAP queue 3)
PARITY_CFG = dict(num_clients=32, num_clusters=3, rounds=12,
                  rounds_per_global=3, eval_every=4, samples_per_client=32,
                  batch_size=16, local_steps=1, eval_size=256,
                  round_minutes=4.0)
NATIVE_CFG = dict(num_clients=32, num_clusters=3, rounds=16,
                  rounds_per_global=4, eval_every=8, samples_per_client=16,
                  batch_size=8, local_steps=1, eval_size=64)


def _cfg(method, **kw):
    return FLRunConfig(**{**NATIVE_CFG, "method": method, **kw})


def _sim(cfg):
    return tengine.simulate(cfg, device="cpu")


def _cadence(cfg):
    return ((np.arange(cfg.rounds) + 1) % cfg.rounds_per_global
            == 0).astype(np.int32)


# ---- parity with the reference engine -------------------------------------

PARITY_CASES = {
    # misses a window on cadence, catches up, ends pending
    "fedspace": dict(method="fedspace", gs_min_elevation_deg=30.0),
    "fedspace-bf16": dict(method="fedspace", gs_min_elevation_deg=30.0,
                          contact_dtype="bfloat16"),
    "fedspace-sliced": dict(method="fedspace", gs_min_elevation_deg=30.0,
                            contact_slices=True),
    "fedspace-factorized": dict(method="fedspace", gs_min_elevation_deg=30.0,
                                contact_factorized=True),
    # fires on cadence, with members that have no route to their PS
    "isl-onboard": dict(method="isl-onboard", isl_max_range_km=6000.0,
                        isl_max_hops=3),
    # a fragmented graph: no window ever
    "isl-onboard-stalled": dict(method="isl-onboard",
                                isl_max_range_km=5000.0, isl_max_hops=3),
}


@pytest.mark.parametrize("case", list(PARITY_CASES))
def test_gated_parity_from_bridged_inputs(case):
    tcfg, state0, data, draws, jcfg = bridged(**PARITY_CFG,
                                              **PARITY_CASES[case])
    kind = ("FactorizedContactPlan" if tcfg.contact_factorized else
            "ClusterContactPlan" if tcfg.contact_slices else "ContactPlan")
    assert type(data.plan).__name__ == kind
    state, outs = tengine.simulate(tcfg, device="cpu", state0=state0,
                                   data=data, draws=draws)
    jstate, jouts = jengine.simulate(jcfg)
    jouts = jax.device_get(jouts)
    np.testing.assert_array_equal(outs.did_global,
                                  np.asarray(jouts.did_global))
    assert state.pending_global == bool(jstate.pending_global)
    np.testing.assert_allclose(outs.time_s, jouts.time_s, rtol=1e-5)
    np.testing.assert_allclose(outs.energy_j, jouts.energy_j, rtol=1e-5)
    np.testing.assert_allclose(outs.loss, jouts.loss, rtol=1e-3, atol=1e-5)
    ev = np.asarray(jouts.evaluated)
    np.testing.assert_array_equal(outs.evaluated, ev)
    np.testing.assert_allclose(outs.acc[ev], np.asarray(jouts.acc)[ev],
                               atol=5e-3)
    h = tengine.history_from_outputs(outs)
    assert h["global_rounds"] == jengine.history_from_outputs(
        jouts)["global_rounds"]
    if case == "fedspace":
        cadence = _cadence(tcfg).astype(bool)
        assert np.any(cadence & (outs.did_global == 0))
        assert np.any(~cadence & (outs.did_global == 1))
    if case == "isl-onboard":
        # some member of the static layout has no route to its PS in some
        # sample of the plan
        ps = state0.ps_index.long()[state0.assignment.long()]
        tpb = data.plan.isl_tpb[:, torch.arange(32), ps]
        assert not torch.isfinite(tpb).all()


# ---- the deferral pins, on the port's own draws ---------------------------


@pytest.mark.parametrize("method", ["fedspace", "isl-onboard"])
def test_gated_methods_run_through_api(method):
    """``api.run`` on the CPU: finite histories, monotone costs and
    stage-2 firing through the contact plan; the sliced and factorized
    plans give the full plan's trajectory."""
    sc = tapi.Scenario.from_flat(_cfg(method, rounds=8))
    res = tapi.run(sc, device="cpu")
    for key in ("acc", "loss", "time_s", "energy_j"):
        assert np.all(np.isfinite(getattr(res, key)))
    assert np.all(np.diff(res.time_s) > 0)
    assert np.all(np.diff(res.energy_j) > 0)
    assert res.global_rounds >= 1
    for layout in ("contact_slices", "contact_factorized"):
        other = tapi.run(sc.replace(comms=dataclasses.replace(
            sc.comms, **{layout: True})), device="cpu")
        assert other.global_rounds == res.global_rounds
        np.testing.assert_allclose(other.time_s, res.time_s, rtol=1e-5)
        np.testing.assert_allclose(other.energy_j, res.energy_j, rtol=1e-5)
        np.testing.assert_allclose(other.loss, res.loss, rtol=1e-3)


def test_fedspace_blackout_defers_forever():
    """A ~90 deg elevation mask closes every window: stage 2 never fires,
    the pending flag is still set at the end, and the closed windows cost
    nothing: time and energy equal a run on which no stage-2 is ever
    due."""
    state, outs = _sim(_cfg("fedspace", gs_min_elevation_deg=89.9))
    assert outs.did_global.sum() == 0
    assert state.pending_global is True
    _, never = _sim(_cfg("fedspace", gs_min_elevation_deg=89.9,
                         rounds_per_global=1000))
    np.testing.assert_array_equal(outs.time_s, never.time_s)
    np.testing.assert_array_equal(outs.energy_j, never.energy_j)


def test_fedspace_open_sky_fires_on_cadence():
    """With the mask fully open stage 2 fires exactly on the cadence and
    nothing stays pending."""
    cfg = _cfg("fedspace", gs_min_elevation_deg=-90.0)
    state, outs = _sim(cfg)
    np.testing.assert_array_equal(outs.did_global, _cadence(cfg))
    assert state.pending_global is False


def test_fedspace_defers_then_catches_up():
    """A 30 deg mask opens windows intermittently: a cadence round finds
    the sky closed, and the pending flag fires the aggregation at the
    next open round."""
    cfg = _cfg("fedspace", rounds=24, round_minutes=4.0,
               gs_min_elevation_deg=30.0)
    _, outs = _sim(cfg)
    dg, cadence = outs.did_global, _cadence(cfg).astype(bool)
    assert np.any(cadence & (dg == 0)), dg
    assert np.any(~cadence & (dg == 1)), dg


def test_isl_onboard_ignores_ground_station():
    """isl-onboard's stage 2 has no ground station: the elevation mask
    changes nothing."""
    _, lo = _sim(_cfg("isl-onboard", gs_min_elevation_deg=10.0))
    _, hi = _sim(_cfg("isl-onboard", gs_min_elevation_deg=89.0))
    assert lo.did_global.sum() == hi.did_global.sum() >= 1
    np.testing.assert_array_equal(lo.time_s, hi.time_s)


def test_isl_onboard_stalls_without_links():
    """No ISL in range: no PS pair reaches another, stage 2 never fires,
    and the run stays finite (each PS reaches itself)."""
    state, outs = _sim(_cfg("isl-onboard", isl_max_range_km=1.0))
    assert outs.did_global.sum() == 0 and state.pending_global
    for key in ("time_s", "energy_j"):
        assert np.all(np.isfinite(getattr(outs, key)))
    assert np.all(np.isfinite(outs.acc[outs.evaluated]))


# ---- host reads -----------------------------------------------------------


@pytest.mark.parametrize("method,mask", [("fedspace", 30.0),
                                         ("fedspace", 89.9),
                                         ("isl-onboard", 10.0)])
def test_host_reads_one_per_due_round(method, mask):
    """A gated run reads the window on the host on due rounds only: on
    cadence, and on every round while a stage-2 is pending."""
    cfg = _cfg(method, rounds=24, round_minutes=4.0,
               gs_min_elevation_deg=mask)
    tengine.reset_host_reads()
    _, outs = _sim(cfg)
    pending, due = False, 0
    for rnd in range(cfg.rounds):
        if (rnd + 1) % cfg.rounds_per_global == 0 or pending:
            due += 1
            pending = not outs.did_global[rnd]
    assert tengine.HOST_READS == {"window": due, "recluster": 0,
                                "stage2": 0}
    assert due > cfg.rounds // cfg.rounds_per_global or method != "fedspace"


def test_always_up_methods_read_no_window():
    cfg = _cfg("fedhc", rounds=8)
    tengine.reset_host_reads()
    _sim(cfg)
    assert tengine.HOST_READS == {"window": 0, "recluster": 2, "stage2": 0}
    tengine.reset_host_reads()
    _sim(_cfg("h-base", rounds=8))
    assert tengine.HOST_READS == {"window": 0, "recluster": 0, "stage2": 0}


def test_plan_layouts_need_a_static_layout():
    """The reference's ``_plan_for`` errors: slices under a re-clustering
    strategy, both layouts at once, a factorized plan for an async
    strategy."""
    layout = (torch.zeros(32, dtype=torch.int32),
              torch.zeros(3, dtype=torch.int32))
    gated_recluster = tstrat.Strategy(name="gated-recluster",
                                      connectivity="visibility")
    with pytest.raises(ValueError, match="static cluster layout"):
        tengine._plan_for(_cfg("fedspace", contact_slices=True),
                          gated_recluster, layout, device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        tengine._plan_for(_cfg("fedspace", contact_slices=True,
                               contact_factorized=True),
                          tstrat.get("fedspace"), layout, device="cpu")
    with pytest.raises(ValueError, match="sync-engine-only"):
        tengine._plan_for(_cfg("fedspace-async", contact_factorized=True),
                          tstrat.get("fedspace-async"), layout, device="cpu")
    assert tengine._plan_for(_cfg("fedhc"), tstrat.get("fedhc")) is None


def _links_ctx(method, vis, dist, tpb):
    """The engine's per-run context and a round state around a hand-made
    one-sample plan (N = 6, two clusters with PSs 0 and 3)."""
    plan = tcontact.ContactPlan(torch.zeros(1), vis, dist, tpb)
    cfg = _cfg(method, num_clients=6, num_clusters=2)
    ctx = tengine._Ctx(cfg=cfg, strategy=tstrat.get(method),
                       data=tengine.SimData(*([None] * 7), plan=plan),
                       draws=None, k=2, constellation=None,
                       model_bits=1000.0, use_kernels=False)
    state = tengine.RoundState(
        params=None, assignment=torch.tensor([0, 0, 0, 1, 1, 1]),
        centroids=None, ps_index=torch.tensor([0, 3], dtype=torch.int32),
        t_sim=torch.tensor(0.0), e_sim=None, reclusters=0)
    return ctx, state


def test_gateway_takes_the_first_minimum():
    """fedspace's gateway is the first GS-visible satellite minimizing the
    worst PS route (satellites 1 and 2 tie; 1 is taken); with no visible
    satellite the window is closed; an unreachable member is out."""
    inf = float("inf")
    tpb = torch.full((1, 6, 6), 2.0)
    tpb[0].fill_diagonal_(0.0)
    tpb[0, :, 5] = tpb[0, 5, :] = inf           # satellite 5: no route
    tpb[0, 5, 5] = 0.0
    tpb[0, [0, 3], 4] = tpb[0, 4, [0, 3]] = 3.0  # a worse gateway
    vis = torch.tensor([[False, True, True, False, True, False]])
    dist = torch.tensor([[9e3, 1500.0, 1200.0, 9e3, 800.0, 9e3]])
    ctx, state = _links_ctx("fedspace", vis, dist, tpb)
    links = tengine._gated_links(ctx, state, due=True)
    assert links.participating.tolist() == [True] * 5 + [False]
    window, t_g, e_g = links.stage2
    want = tcost.routed_ground_round_costs(
        tpb[0, [0, 3], 1], dist[0, 1], model_bits=1000.0, lp=ctx.lp)
    assert bool(window)
    assert torch.equal(t_g, want[0]) and torch.equal(e_g, want[1])
    assert tengine._gated_links(ctx, state, due=False).stage2 is None
    ctx, state = _links_ctx("fedspace", torch.zeros_like(vis), dist, tpb)
    assert not bool(tengine._gated_links(ctx, state, due=True).stage2[0])
    # isl-onboard: the PS pair 0-3 has a route; cut it and the window
    # closes
    ctx, state = _links_ctx("isl-onboard", vis, dist, tpb)
    assert bool(tengine._gated_links(ctx, state, due=True).stage2[0])
    cut = tpb.clone()
    cut[0, 0, 3] = cut[0, 3, 0] = inf
    ctx, state = _links_ctx("isl-onboard", vis, dist, cut)
    assert not bool(tengine._gated_links(ctx, state, due=True).stage2[0])
