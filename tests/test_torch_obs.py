"""The port's flight telemetry (``repro_torch.obs``) on the CPU, against
the JAX package.

* Parity: handed the reference's setup and draws
  (`test_torch_jaxref.bridged`), the port's per-round ``Telemetry``
  matches ``repro.api.run``'s with telemetry on, field by field:
  ``cohort_size``, ``accepted``, ``flushes``, ``did_global``,
  ``reclustered``, ``cluster_fill`` and the hop counts exact (hops on the
  4 x 8 constellation, where reachability matches exactly); the traffic,
  ``t_round_s``, the energy split and the staleness spread rtol 1e-5.
  Cases: fedhc (re-clustering), c-fedavg, fedspace (N = 32, 6000 km ISLs,
  where windows open) and fedhc-async.
* Telemetry on leaves ``to_history()`` equal with ``==``, and leaves the
  engine's host reads and the kernel-wrapper calls unchanged, sync and
  async; the energy and time series reconcile with the history.
* The host plane: span nesting, ``phase_times``, ``Counters.delta``, the
  setup-cache counters; ``phase_scope`` opens only under a capture.
* Files: a ``RunResult`` with telemetry saved by either package loads in
  the other; the Chrome trace validates; the report CLI renders a run
  file of either package.
"""
import contextlib
import dataclasses
import json

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from repro import api as japi
from repro.core.fedhc import FLRunConfig as JaxConfig
from repro.obs import report as jreport

from repro_torch import api as tapi
from repro_torch.core import engine as tengine
from repro_torch.core.fedhc import FLRunConfig
from repro_torch.kernels import ops as tops
from repro_torch.obs import report as treport
from repro_torch.obs import telemetry as ttelem
from repro_torch.obs.trace import COUNTERS, Counters, Tracer, phase_scope

from test_torch_jaxref import bridged

SMALL = dict(samples_per_client=16, batch_size=8, local_steps=1,
             eval_size=64, eval_every=3)
PARITY_CASES = {
    # 4-minute rounds and Z = 0.2: the re-cluster branch fires
    "fedhc": dict(method="fedhc", num_clients=16, num_clusters=3, rounds=6,
                  rounds_per_global=2, dropout_threshold=0.2,
                  round_minutes=4.0),
    "c-fedavg": dict(method="c-fedavg", num_clients=12, num_clusters=2,
                     rounds=4),
    "fedspace": dict(method="fedspace", num_clients=32, num_clusters=3,
                     rounds=6, rounds_per_global=2, round_minutes=4.0,
                     isl_max_range_km=6000.0, gs_min_elevation_deg=30.0),
    "fedhc-async": dict(method="fedhc-async", num_clients=16,
                        num_clusters=2, rounds=8, rounds_per_global=2,
                        async_cohort=4, async_buffer=3),
}
EXACT = ("cohort_size", "accepted", "flushes", "did_global", "reclustered",
         "cluster_fill", "hops_mean", "hops_max")
RTOL = ("bits_stage1", "bits_stage2", "t_round_s", "e_compute_j",
        "e_comm_j", "stale_min", "stale_mean", "stale_max")
assert set(EXACT + RTOL) == set(ttelem.Telemetry._fields)


@pytest.mark.parametrize("case", list(PARITY_CASES))
def test_telemetry_matches_reference_from_bridged_inputs(case):
    cfg = dict(SMALL, **PARITY_CASES[case], telemetry=True)
    tcfg, state0, data, draws, jcfg = bridged(**cfg)
    _, outs = tengine.simulate(tcfg, device="cpu", state0=state0, data=data,
                               draws=draws)
    outs, telem = tengine.split_outputs(outs)
    got = ttelem.rounds_from_scan(telem)
    want = japi.run(japi.Scenario.from_flat(jcfg)).telemetry.rounds
    assert set(got) == set(want)
    for name in EXACT:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    for name in RTOL:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                   err_msg=name)
    assert got["cluster_fill"].shape == (
        tcfg.rounds, 1 if case == "c-fedavg" else tcfg.num_clusters)
    # each case exercises what it is there for
    if case == "fedhc":
        assert got["reclustered"].sum() >= 1
    if case == "fedspace":
        assert got["did_global"].sum() >= 1 and got["hops_max"].max() >= 2
    if case == "fedhc-async":
        assert got["flushes"].sum() >= 1 and got["stale_max"].max() >= 1


def _scenario(method, telemetry, **kw):
    flat = dict(SMALL, method=method, num_clients=12, num_clusters=2,
                rounds=6, rounds_per_global=2, dropout_threshold=0.2,
                round_minutes=4.0, use_pallas_kernels=True, seed=5)
    flat.update(kw)
    return tapi.Scenario.from_flat(FLRunConfig(**flat, telemetry=telemetry))


ON_OFF = {
    "fedhc": {},
    "c-fedavg": {},
    "fedspace": dict(num_clients=32, num_clusters=3,
                     isl_max_range_km=6000.0),
    "fedhc-async": dict(async_cohort=4, async_buffer=3),
    "fedspace-async": dict(num_clients=32, num_clusters=3, async_cohort=8,
                           async_buffer=4, isl_max_range_km=6000.0),
}


@pytest.fixture(scope="module")
def on_off():
    """For each ON_OFF case: (off result, on result, (host reads,
    kernel-wrapper calls) off, on), off and on sharing one setup."""
    calls = {"kmeans_assign": 0, "weighted_agg_multi_tree": 0}
    mp = pytest.MonkeyPatch()
    for name in calls:                  # the CPU takes the plain path and
        fn = getattr(tops, name)        # counts no launch: count the calls

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        mp.setattr(tops, name, counted)
    out = {}
    try:
        for case, kw in ON_OFF.items():
            cache, runs = {}, []
            for telemetry in (False, True):
                tengine.reset_host_reads()
                for name in calls:
                    calls[name] = 0
                res = tapi.run(_scenario(case, telemetry, **kw),
                               device="cpu", setup_cache=cache)
                runs.append((res, (dict(tengine.HOST_READS), dict(calls))))
            out[case] = (runs[0][0], runs[1][0], runs[0][1], runs[1][1])
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("case", list(ON_OFF))
def test_telemetry_on_leaves_trajectory_and_work_unchanged(on_off, case):
    off, on, work_off, work_on = on_off[case]
    assert off.telemetry is None
    assert on.to_history() == off.to_history()
    assert work_on == work_off
    if case != "c-fedavg":      # the centralized round calls neither
        assert sum(work_on[0].values()) > 0      # the run reads the host
        assert sum(work_on[1].values()) > 0      # and calls the kernels


@pytest.mark.parametrize("case", list(ON_OFF))
def test_series_reconcile_with_the_history(on_off, case):
    """Per-round time and energy cumulate to the history's eval points;
    stage-2 firings and re-clusters sum to its totals; compute energy is
    a positive part of every round's energy."""
    _, on, _, _ = on_off[case]
    r = on.telemetry.rounds
    assert on.telemetry.num_rounds == 6
    idx = on.round - 1
    t = np.cumsum(r["t_round_s"].astype(np.float64))
    e = np.cumsum(r["e_compute_j"].astype(np.float64)
                  + r["e_comm_j"].astype(np.float64))
    np.testing.assert_allclose(t[idx], on.time_s, rtol=1e-5)
    np.testing.assert_allclose(e[idx], on.energy_j, rtol=1e-5)
    assert r["did_global"].sum() == on.global_rounds
    assert r["reclustered"].sum() == on.reclusters
    assert np.all(r["e_compute_j"] > 0) and np.all(r["e_comm_j"] > 0)
    if on.flushes is not None:
        assert r["flushes"].sum() == on.flushes
        np.testing.assert_allclose(r["stale_mean"].mean(),
                                   on.mean_staleness, rtol=1e-5)


def test_host_spans_and_counters(on_off):
    _, on, _, _ = on_off["fedhc"]
    names = [s["name"] for s in on.telemetry.spans]
    # the setup came from the shared cache: no setup span on a hit
    assert names == ["compile", "run", "fetch"]
    assert on.telemetry.counters == {"api.setup_cache.hit": 1}
    times = on.telemetry.phase_times()
    assert set(times) == {"compile", "run", "fetch"}
    assert times["run"] > 0
    assert on.run_s == pytest.approx(times["run"] + times["fetch"],
                                     abs=5e-3)


def test_tracer_nesting_and_phase_scope():
    tr = Tracer()
    with tr.span("outer", k=1):
        with tr.span("inner", annotate=False):
            pass
        with phase_scope("fed_step/local_train"):
            pass
    # no capture running: the one shared no-op context, no range
    off = phase_scope("off")
    assert isinstance(off, contextlib.nullcontext)
    assert off is phase_scope("fed_step/local_train")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with phase_scope("on"):
            pass
    assert [e.name for e in prof.events() if e.name in ("on", "off")] \
        == ["on"]
    d = tr.span_dicts()
    assert [s["name"] for s in d] == ["outer", "inner"]
    assert [s["depth"] for s in d] == [0, 1]
    assert d[0]["args"] == {"k": 1}
    assert d[0]["dur_us"] >= d[1]["dur_us"] >= 0
    assert d[0]["ts_us"] <= d[1]["ts_us"]
    assert set(tr.phase_times()) == {"outer"}


def test_counters_inc_and_delta():
    c0 = COUNTERS.snapshot()
    COUNTERS.inc("test.obs.a")
    COUNTERS.inc("test.obs.a", 2)
    COUNTERS.inc("test.obs.b")
    d = Counters.delta(c0, COUNTERS.snapshot())
    assert d == {"test.obs.a": 3, "test.obs.b": 1}
    assert Counters.delta(COUNTERS.snapshot(), COUNTERS.snapshot()) == {}


def test_setup_cache_counts_hits_and_misses():
    """Counted on every call with a setup_cache, telemetry on or off:
    exec-only knobs share a setup, another seed does not."""
    cache = {}
    c0 = COUNTERS.snapshot()
    tapi.run(_scenario("h-base", False, rounds=2), device="cpu",
             setup_cache=cache)
    tapi.run(_scenario("h-base", True, rounds=2), device="cpu",
             setup_cache=cache)
    tapi.run(_scenario("h-base", False, rounds=2, seed=6), device="cpu",
             setup_cache=cache)
    tapi.run(_scenario("h-base", False, rounds=2), device="cpu")
    d = Counters.delta(c0, COUNTERS.snapshot())
    assert d == {"api.setup_cache.miss": 2, "api.setup_cache.hit": 1}


def test_plan_builds_are_counted():
    """A gated setup builds one contact plan; a sweep builds one for all
    its seeds and hands it to each."""
    c0 = COUNTERS.snapshot()
    tapi.run(_scenario("fedspace", False, **ON_OFF["fedspace"], rounds=2),
             device="cpu")
    tapi.run_sweep(_scenario("fedspace", False, **ON_OFF["fedspace"],
                             rounds=2), (1, 2, 3), device="cpu")
    d = Counters.delta(c0, COUNTERS.snapshot())
    assert d == {"engine.plan_cache.miss": 2, "engine.plan_cache.hit": 3}


def test_run_result_telemetry_loads_across_packages(tmp_path, on_off):
    _, on, _, _ = on_off["fedhc-async"]
    on.save(str(tmp_path / "port.json"))
    j = japi.RunResult.load(str(tmp_path / "port.json"))
    assert j.telemetry is not None
    assert j.telemetry.spans == on.telemetry.spans
    assert j.telemetry.counters == on.telemetry.counters
    for k, v in on.telemetry.rounds.items():
        np.testing.assert_array_equal(j.telemetry.rounds[k], v)
    # and back: the reference's save, loaded by the port
    j.save(str(tmp_path / "ref.json"))
    with open(tmp_path / "port.json") as f, open(tmp_path / "ref.json") as g:
        assert json.load(f) == json.load(g)
    back = tapi.RunResult.load(str(tmp_path / "ref.json"))
    assert isinstance(back.telemetry, ttelem.RunTelemetry)
    assert back.telemetry.to_dict() == on.telemetry.to_dict()
    assert back.to_history() == on.to_history()


def test_reference_telemetry_file_loads_in_the_port(tmp_path):
    jsc = japi.Scenario.from_flat(JaxConfig(
        **dict(SMALL, method="h-base", num_clients=8, num_clusters=2,
               rounds=3, telemetry=True)))
    jres = japi.run(jsc)
    jres.save(str(tmp_path / "ref.json"))
    t = tapi.RunResult.load(str(tmp_path / "ref.json"))
    assert t.scenario.canonical_json() == jsc.canonical_json()
    assert [s["name"] for s in t.telemetry.spans] == [
        s["name"] for s in jres.telemetry.spans]
    for k, v in jres.telemetry.rounds.items():
        np.testing.assert_array_equal(t.telemetry.rounds[k], v)
    assert treport.render(t).startswith("== run report: h-base ==")


def test_chrome_trace_export(tmp_path, on_off):
    _, on, _, _ = on_off["fedspace"]
    path = str(tmp_path / "trace" / "t.json")
    on.telemetry.save_chrome_trace(path)
    d = ttelem.load_chrome_trace(path)
    phs = {e["ph"] for e in d["traceEvents"]}
    assert {"M", "X", "C", "I"} <= phs
    hops = [e for e in d["traceEvents"] if e["name"] == "hops"]
    assert len(hops) == 6 and max(e["args"]["hops_max"] for e in hops) > 0
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"traceEvents": [{"name": "x"}]}))
    with pytest.raises(ValueError, match="malformed"):
        ttelem.load_chrome_trace(str(bad))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_report_cli_renders_either_package(tmp_path, capsys, on_off,
                                           writer):
    _, on, _, _ = on_off["fedhc"]
    path = str(tmp_path / "run.json")
    (on if writer == "port" else japi.RunResult.load(
        _saved(on, tmp_path))).save(path)
    trace = str(tmp_path / "trace.json")
    assert treport.main([path, "--rows", "4", "--trace", trace]) == 0
    out = capsys.readouterr().out
    assert "== run report: fedhc ==" in out
    assert "-- device plane: 6 rounds --" in out
    assert "(2 more rounds)" in out
    assert "counters: api.setup_cache.hit=1" in out
    ttelem.load_chrome_trace(trace)
    # the reference's CLI renders the same file the same way
    assert jreport.main([path, "--rows", "4"]) == 0
    assert capsys.readouterr().out in out


def _saved(res, tmp_path):
    path = str(tmp_path / "first.json")
    res.save(path)
    return path


def test_report_without_telemetry_says_so(tmp_path, capsys, on_off):
    off, _, _, _ = on_off["c-fedavg"]
    path = str(tmp_path / "off.json")
    off.save(path)
    assert treport.main([path]) == 0
    assert "no device-plane telemetry" in capsys.readouterr().out
    assert treport.main([path, "--trace", str(tmp_path / "t.json")]) == 2


def test_fetch_is_one_copy_of_series_and_rows():
    """``telemetry.fetch`` splits the combined copy back exactly: device
    columns (scalars and (K,) vectors) and host values per round."""
    import torch
    series = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    rows = [ttelem.Telemetry(
        cohort_size=4, accepted=torch.tensor(3.0 + i),
        cluster_fill=torch.tensor([1.0, 2.0 + i]), stale_min=0.0,
        stale_mean=0.0, stale_max=0.0, flushes=2, did_global=i % 2,
        reclustered=0, bits_stage1=torch.tensor(1e6 * i), bits_stage2=0.0,
        t_round_s=torch.tensor(0.5), e_compute_j=torch.tensor(1.0),
        e_comm_j=torch.tensor(2.0), hops_mean=0.0, hops_max=0.0)
        for i in range(3)]
    got_series, telem = ttelem.fetch(series, rows)
    np.testing.assert_array_equal(got_series, series.numpy())
    r = ttelem.rounds_from_scan(telem)
    assert r["accepted"].tolist() == [3, 4, 5]
    assert r["accepted"].dtype == np.int32
    assert r["cluster_fill"].tolist() == [[1, 2], [1, 3], [1, 4]]
    assert r["did_global"].tolist() == [0, 1, 0]
    assert r["bits_stage1"].dtype == np.float32
    assert r["cohort_size"].tolist() == [4, 4, 4]


def test_exec_spec_default_off_and_scenario_round_trip():
    sc = tapi.Scenario()
    assert sc.exec.telemetry is False
    on = sc.replace(exec=dataclasses.replace(sc.exec, telemetry=True))
    assert tapi.Scenario.from_json(on.to_json()) == on
    assert on.to_flat().telemetry is True
