"""The port's results surface on the CPU, against the JAX package.

* ``RunResult.time_to_accuracy``/``final_acc``/``wall_s`` and
  ``fedhc.time_energy_to_accuracy`` equal the reference's on one history.
* Result files: ``RunResult`` and ``SweepResult`` saved by one package
  load in the other, and both write the same JSON for the same result.
* ``run_sweep``/``run_many_seeds``: equal, seed for seed, to a loop of
  ``api.run``, with one contact plan built for all seeds; on bridged
  inputs (`test_torch_jaxref.bridged`) each seed meets the reference's
  ``run_many_seeds`` at the golden bar: re-clusters and global rounds
  exact, time and energy rtol 1e-5, loss rtol 1e-3, accuracy atol 5e-3
  (eval_size 256: one test image is 0.0039).
* ``run_fl`` on bridged inputs against the reference's, the paper
  presets field for field, the live ``METHODS`` view.
"""
import dataclasses
import json

import numpy as np
import pytest

from repro import api as japi
from repro.configs import fedhc_paper as jpaper
from repro.core import engine as jengine
from repro.core import fedhc as jfedhc

from repro_torch import api as tapi
from repro_torch.configs import fedhc_paper as tpaper
from repro_torch.core import engine as tengine
from repro_torch.core import fedhc as tfedhc
from repro_torch.core import strategies as tstrat
from repro_torch.orbits import contact as tcontact

from test_torch_jaxref import bridged

ROUND = np.array([5, 10, 15, 20])
ACC = np.array([0.25, 0.5, 0.45, 0.75])
TIME = np.array([100.0, 210.5, 330.25, 480.0])
ENERGY = np.array([1e3, 2.5e3, 3.75e3, 5e3])


def _scenarios(method="fedhc-async"):
    kw = dict(method=method, seed=3)
    return (tapi.Scenario(fleet=tapi.FleetSpec(num_clients=32),
                          async_=tapi.AsyncSpec(cohort=8), **kw),
            japi.Scenario(fleet=japi.FleetSpec(num_clients=32),
                          async_=japi.AsyncSpec(cohort=8), **kw))


def _run_results():
    """One result in each package, field for field the same."""
    tsc, jsc = _scenarios()
    fields = dict(round=ROUND, acc=ACC, loss=np.array([2.0, 1.5, 1.2, 1.0]),
                  time_s=TIME, energy_j=ENERGY, reclusters=0,
                  global_rounds=2, strategy=dataclasses.asdict(
                      tstrat.get("fedhc-async")),
                  mesh_shape=None, setup_s=0.5, compile_s=1.25, run_s=2.0,
                  flushes=14, mean_staleness=0.75, peak_device_mem_mb=None,
                  peak_host_mem_mb=321.5)
    return (tapi.RunResult(scenario=tsc, **fields),
            japi.RunResult(scenario=jsc, **fields))


@pytest.mark.parametrize("target", [0.0, 0.3, 0.5, 0.74, 0.75, 0.99])
def test_time_to_accuracy_final_acc_and_wall_s_match_reference(target):
    tres, jres = _run_results()
    got, want = tres.time_to_accuracy(target), jres.time_to_accuracy(target)
    assert (got is None) == (want is None)
    if want is not None:
        assert tuple(got) == tuple(want)
        assert got._fields == want._fields
    assert tres.final_acc == jres.final_acc and tres.wall_s == jres.wall_s
    h = tres.to_history()
    assert h == jres.to_history()
    assert (tfedhc.time_energy_to_accuracy(h, target)
            == jfedhc.time_energy_to_accuracy(h, target))
    if target == 0.99:
        assert got is None
        assert tfedhc.time_energy_to_accuracy(h, target) == (
            float("inf"), float("inf"), -1)


def test_run_result_files_load_across_packages(tmp_path):
    """Both packages write the same JSON for the same result, and each
    loads the other's file."""
    tres, jres = _run_results()
    tres.save(str(tmp_path / "port" / "run.json"))
    jres.save(str(tmp_path / "ref.json"))
    with open(tmp_path / "port" / "run.json") as f:
        dt = json.load(f)
    with open(tmp_path / "ref.json") as f:
        dj = json.load(f)
    assert dt == dj
    j_from_t = japi.RunResult.load(str(tmp_path / "port" / "run.json"))
    t_from_j = tapi.RunResult.load(str(tmp_path / "ref.json"))
    assert j_from_t.to_history() == tres.to_history()
    assert t_from_j.to_history() == jres.to_history()
    assert t_from_j.scenario == tres.scenario
    assert j_from_t.scenario == jres.scenario
    for name in ("setup_s", "compile_s", "run_s", "peak_device_mem_mb",
                 "peak_host_mem_mb", "strategy", "mesh_shape", "flushes",
                 "mean_staleness"):
        assert getattr(t_from_j, name) == getattr(jres, name), name
    assert t_from_j.telemetry is None and j_from_t.telemetry is None


def test_sweep_result_files_load_across_packages(tmp_path):
    """NaN (a non-eval round) is written as JSON null by both and comes
    back as NaN; the eval-point views agree."""
    tsc, jsc = _scenarios("fedhc")
    g = np.random.default_rng(0)
    ev = np.tile((np.arange(6) + 1) % 3 == 0, (2, 1))
    acc = np.where(ev, g.uniform(size=(2, 6)), np.nan)
    fields = dict(seeds=np.array([17, 18]), acc=acc,
                  loss=g.uniform(1, 2, (2, 6)),
                  time_s=np.cumsum(g.uniform(50, 90, (2, 6)), 1),
                  energy_j=np.cumsum(g.uniform(1, 9, (2, 6)), 1),
                  evaluated=ev, reclusters=np.array([1, 0]),
                  global_rounds=np.array([1, 1]), wall_s=3.5)
    tsw = tapi.SweepResult(scenario=tsc, **fields)
    jsw = japi.SweepResult(scenario=jsc, **fields)
    tsw.save(str(tmp_path / "t.json"))
    jsw.save(str(tmp_path / "j.json"))
    with open(tmp_path / "t.json") as f:
        dt = json.load(f)
    with open(tmp_path / "j.json") as f:
        assert dt == json.load(f)
    assert dt["acc"][0][0] is None
    for back, orig in ((japi.SweepResult.load(str(tmp_path / "t.json")),
                        tsw),
                       (tapi.SweepResult.load(str(tmp_path / "j.json")),
                        jsw)):
        np.testing.assert_array_equal(back.acc, orig.acc)   # NaN == NaN
        np.testing.assert_array_equal(back.eval_rounds, [3, 6])
        np.testing.assert_array_equal(back.final_acc, acc[:, -1])
        np.testing.assert_array_equal(back.eval_curves("time_s"),
                                      orig.time_s[:, [2, 5]])
        assert back.wall_s == 3.5
    np.testing.assert_array_equal(tsw.eval_rounds, jsw.eval_rounds)
    np.testing.assert_array_equal(tsw.final_acc, jsw.final_acc)


# ---- seed sweeps --------------------------------------------------------

SWEEP_CFG = dict(num_clients=32, num_clusters=3, rounds=8,
                 rounds_per_global=2, eval_every=4, samples_per_client=32,
                 batch_size=16, local_steps=1, eval_size=256,
                 round_minutes=4.0)
SWEEP_CASES = {"fedhc": dict(dropout_threshold=0.2),
               "fedspace": dict(gs_min_elevation_deg=30.0)}


def _count_plan_builds(monkeypatch):
    builds = []
    build = tcontact.build_contact_plan

    def counted(*args, **kwargs):
        builds.append(1)
        return build(*args, **kwargs)
    monkeypatch.setattr(tcontact, "build_contact_plan", counted)
    return builds


@pytest.mark.parametrize("method", list(SWEEP_CASES))
def test_run_sweep_equals_a_loop_of_api_run(method, monkeypatch):
    """Each seed of the sweep is ``api.run`` on that seed, bit for bit,
    and a gated sweep builds its contact plan once for all its seeds."""
    fleet = dict(num_clients=32, num_clusters=3, round_minutes=4.0,
                 **({"dropout_threshold": 0.2} if method == "fedhc" else {}))
    sc = tapi.Scenario(
        method=method,
        data=tapi.DataSpec(samples_per_client=16, eval_size=64),
        fleet=tapi.FleetSpec(**fleet),
        train=tapi.TrainSpec(rounds=6, rounds_per_global=2, eval_every=3,
                             local_steps=1, batch_size=8))
    seeds = (0, 5)
    builds = _count_plan_builds(monkeypatch)
    sweep = tapi.run_sweep(sc, seeds, device="cpu")
    assert len(builds) == (1 if method == "fedspace" else 0)
    assert sweep.acc.shape == (2, 6) and sweep.evaluated.shape == (2, 6)
    np.testing.assert_array_equal(sweep.seeds, seeds)
    np.testing.assert_array_equal(sweep.eval_rounds, [3, 6])
    for i, seed in enumerate(seeds):
        res = tapi.run(sc.replace(seed=seed), device="cpu")
        for key in ("acc", "loss", "time_s", "energy_j"):
            np.testing.assert_array_equal(
                sweep.eval_curves(key)[i].astype(np.float64),
                getattr(res, key))
        assert sweep.reclusters[i] == res.reclusters
        assert sweep.global_rounds[i] == res.global_rounds
    if method == "fedhc":
        assert sweep.reclusters.sum() >= 1


@pytest.mark.parametrize("method", list(SWEEP_CASES))
def test_run_many_seeds_matches_reference_on_bridged_inputs(method,
                                                            monkeypatch):
    """Handed each seed's reference setup and draws, and the one
    reference plan for all seeds, ``run_many_seeds`` meets the
    reference's (one vmapped scan over the seeds) seed for seed."""
    seeds = (3, 4)
    cfg = dict(SWEEP_CFG, method=method, **SWEEP_CASES[method])
    inputs = {s: bridged(**cfg, seed=s) for s in seeds}
    tcfg, _, data0, _, jcfg = inputs[seeds[0]]
    plan, handed = data0.plan, []

    def plan_for(cfg_, strategy, cluster_slices=None, *, device=None):
        handed.append(plan)
        return plan

    def setup(cfg_, seed, *, contact_plan=None, device=None):
        assert contact_plan is plan            # the one plan, shared
        _, state0, data, _, _ = inputs[seed]
        return state0, data._replace(plan=contact_plan)
    monkeypatch.setattr(tengine, "_plan_for", plan_for)
    monkeypatch.setattr(tengine, "setup", setup)
    monkeypatch.setattr(tengine, "TorchDraws",
                        lambda cfg_, seed, dev: inputs[seed][3])
    got = tengine.run_many_seeds(tcfg, seeds, device="cpu")
    want = jengine.run_many_seeds(jcfg, seeds)
    assert len(handed) == 1 and (plan is None) == (method == "fedhc")
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["seeds"], want["seeds"])
    np.testing.assert_array_equal(got["reclusters"], want["reclusters"])
    np.testing.assert_array_equal(got["global_rounds"],
                                  want["global_rounds"])
    np.testing.assert_array_equal(got["evaluated"], want["evaluated"])
    np.testing.assert_allclose(got["time_s"], want["time_s"], rtol=1e-5)
    np.testing.assert_allclose(got["energy_j"], want["energy_j"], rtol=1e-5)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-3,
                               atol=1e-5)
    ev = want["evaluated"]
    np.testing.assert_allclose(got["acc"][ev], want["acc"][ev], atol=5e-3)
    if method == "fedhc":
        assert got["reclusters"].sum() >= 1


def test_run_fl_matches_reference_on_bridged_inputs(monkeypatch):
    """``run_fl``'s history dict on the reference's inputs, and
    ``time_energy_to_accuracy`` on both histories."""
    tcfg, state0, data, draws, jcfg = bridged(
        **dict(SWEEP_CFG, num_clients=16), method="fedhc",
        dropout_threshold=0.2)
    monkeypatch.setattr(tengine, "setup",
                        lambda cfg_, seed, **kw: (state0, data))
    monkeypatch.setattr(tengine, "TorchDraws", lambda *a: draws)
    got, want = tfedhc.run_fl(tcfg, device="cpu"), jfedhc.run_fl(jcfg)
    assert set(got) == set(want)
    assert got["round"] == want["round"]
    assert (got["reclusters"], got["global_rounds"]) == (
        want["reclusters"], want["global_rounds"])
    np.testing.assert_allclose(got["time_s"], want["time_s"], rtol=1e-5)
    np.testing.assert_allclose(got["energy_j"], want["energy_j"], rtol=1e-5)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-3)
    np.testing.assert_allclose(got["acc"], want["acc"], atol=5e-3)
    for target in (min(want["acc"]), 2.0):
        t, e, r = tfedhc.time_energy_to_accuracy(got, target)
        jt, je, jr = jfedhc.time_energy_to_accuracy(want, target)
        assert r == jr
        np.testing.assert_allclose([t, e], [jt, je], rtol=1e-5)


def test_sweep_and_run_refuse_what_the_reference_refuses():
    with pytest.raises(ValueError, match="client mesh"):
        tapi.run_sweep(tapi.Scenario(exec=tapi.ExecSpec(mesh_devices=0)),
                       (0,), device="cpu")
    with pytest.raises(ValueError, match="seed-dependent"):
        tengine.run_many_seeds(tfedhc.FLRunConfig(
            method="fedspace", contact_slices=True), (0,), device="cpu")
    with pytest.raises(NotImplementedError, match="sync-only"):
        tengine.run_many_seeds(tfedhc.FLRunConfig(method="fedbuff"), (0,),
                               device="cpu")


def test_setup_cache_reuses_one_setup():
    """Runs that differ only in execution knobs share a setup: the second
    reports no setup time and the same trajectory."""
    sc = tapi.Scenario(
        method="h-base",
        data=tapi.DataSpec(samples_per_client=16, eval_size=64),
        fleet=tapi.FleetSpec(num_clients=8, num_clusters=2),
        train=tapi.TrainSpec(rounds=4, eval_every=2, local_steps=1,
                             batch_size=8))
    cache = {}
    first = tapi.run(sc, device="cpu", setup_cache=cache)
    again = tapi.run(sc.replace(exec=tapi.ExecSpec(client_microbatch=4)),
                     device="cpu", setup_cache=cache)
    assert len(cache) == 1 and again.setup_s < first.setup_s
    np.testing.assert_allclose(again.loss, first.loss, rtol=1e-5)
    np.testing.assert_array_equal(again.time_s, first.time_s)


# ---- presets and the registry view ------------------------------------------


@pytest.mark.parametrize("name", ["MNIST_K4", "CIFAR_K4"])
def test_paper_presets_equal_field_for_field(name):
    t, j = getattr(tpaper, name), getattr(jpaper, name)
    assert ([f.name for f in dataclasses.fields(t)]
            == [f.name for f in dataclasses.fields(j)])
    for f in dataclasses.fields(t):
        a, b = getattr(t, f.name), getattr(j, f.name)
        if f.name == "dataset":
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
        else:
            assert a == b, f.name
    assert tpaper.TARGETS == jpaper.TARGETS


def test_methods_view_is_live():
    """``METHODS`` reads the registry on every access: a strategy
    registered later shows up.  The built-in ten equal the reference's."""
    assert tfedhc.methods()[:10] == jfedhc.methods()[:10]
    assert tuple(tfedhc.METHODS) == tfedhc.methods()
    name = "fedhc-results-probe"
    if name not in tstrat.names():
        assert name not in tfedhc.METHODS
        tstrat.register(dataclasses.replace(tstrat.get("h-base"), name=name))
    assert name in tfedhc.METHODS and tfedhc.METHODS[-1] in tstrat.names()
    assert len(tfedhc.METHODS) == len(tstrat.names())
    assert tfedhc.METHODS == tstrat.names() and "nope" not in tfedhc.METHODS
