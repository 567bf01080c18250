"""The port's fleet sweep service (``repro_torch.fleet``) on the CPU,
against the JAX package.

* Grids: cell keys, labels and ``grid_hash`` equal the reference's for
  the committed grids (``benchmarks/grids/demo24.json``,
  ``fleet_smoke.json``) and for built grids; expansion errors match.
* Plans: the same classes (keys, step keys, modes), jobs, deduplication
  (c-fedavg across K) and setup classes as ``repro.fleet.plan_grid``.
* Inert-knob normalization preserves the port's trajectory.
* Execution: resume runs only the missing cells, a finished grid re-runs
  as a no-op, an edited manifest is rejected, exec-only knobs share one
  setup, a gated class builds one contact plan.
* Stores interoperate both ways through ``SweepStore.query``, and the
  report CLI renders a port store.
"""
import json
import os

import numpy as np
import pytest

from repro import fleet as jfleet
from repro.obs import report as jreport

from repro_torch import api as tapi
from repro_torch import fleet as tfleet
from repro_torch.fleet import smoke as tsmoke
from repro_torch.obs import report as treport
from repro_torch.obs.trace import COUNTERS, Counters

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO24 = os.path.join(REPO, "benchmarks", "grids", "demo24.json")
SMOKE = os.path.join(REPO, "benchmarks", "grids", "fleet_smoke.json")

TINY_BASE = {
    "data.eval_size": 64, "data.samples_per_client": 16,
    "fleet.num_clients": 8, "fleet.num_clusters": 2,
    "train.batch_size": 8, "train.eval_every": 2,
    "train.local_steps": 1, "train.rounds": 2,
}
EXEC_AXIS = {"name": "exec", "values": [
    {"label": "plain", "set": {"exec.client_microbatch": 0}},
    {"label": "mb4", "set": {"exec.client_microbatch": 4}},
    {"label": "tele", "set": {"exec.telemetry": True}},
    {"label": "mb4-tele", "set": {"exec.client_microbatch": 4,
                                  "exec.telemetry": True}}]}
GRIDS = {
    "demo24": DEMO24,
    "fleet_smoke": SMOKE,
    "cfedavg-k": {"name": "cfa", "base": TINY_BASE, "axes": [
        {"path": "method", "values": ["c-fedavg"]},
        {"path": "fleet.num_clusters", "values": [2, 3]},
        {"path": "seed", "values": [0, 1]}]},
    "loopy": {"name": "loopy", "base": TINY_BASE, "axes": [
        {"path": "method", "values": ["fedbuff", "fedhc", "fedspace"]},
        {"path": "seed", "values": [0, 1]}]},
    "exec-knobs": {"name": "exec-knobs", "base": TINY_BASE,
                   "axes": [EXEC_AXIS]},
    "inert": {"name": "inert", "base": TINY_BASE, "axes": [
        {"path": "method", "values": ["h-base", "fedhc"]},
        {"path": "fleet.dropout_threshold", "values": [0.1, 0.9]},
        {"path": "train.maml_alpha", "values": [0.01, 0.123]}]},
    "smoke-torch": tsmoke.SMOKE_GRID,
}


def _grids(name):
    g = GRIDS[name]
    if isinstance(g, str):
        return tfleet.SweepGrid.load(g), jfleet.SweepGrid.load(g)
    return tfleet.SweepGrid.from_dict(g), jfleet.SweepGrid.from_dict(g)


def _tiny_grid(name, *axes, base=None):
    return tfleet.SweepGrid.from_dict(
        {"name": name, "base": base or TINY_BASE, "axes": list(axes)})


@pytest.mark.parametrize("name", list(GRIDS))
def test_cell_keys_and_grid_hash_equal_the_reference(name):
    tg, jg = _grids(name)
    assert tg.to_dict() == jg.to_dict()
    assert tg.grid_hash() == jg.grid_hash()
    assert tg.to_json() == jg.to_json()
    tc, jc = tg.cells(), jg.cells()
    assert [(c.key, c.label) for c in tc] == [(c.key, c.label) for c in jc]
    assert [c.scenario.canonical_json() for c in tc] == [
        c.scenario.canonical_json() for c in jc]


@pytest.mark.parametrize("name", list(GRIDS))
def test_plan_equals_the_reference(name):
    tg, jg = _grids(name)
    tp, jp = tfleet.plan_grid(tg), jfleet.plan_grid(jg)
    assert tp.to_dict() == jp.to_dict()
    assert [c.mode for c in tp.classes] == [c.mode for c in jp.classes]
    assert tp.num_compiles == jp.num_compiles


def test_demo24_plan_four_vmap_classes_and_cfedavg_dedupes():
    plan = tfleet.plan_grid(tfleet.SweepGrid.load(DEMO24))
    assert [c.mode for c in plan.classes] == ["vmap"] * 4
    assert len(plan.setup_classes) == 24
    cfa = tfleet.plan_grid(_grids("cfedavg-k")[0])
    assert len(cfa.cells) == 4 and len(cfa.classes) == 1
    assert len(cfa.classes[0].jobs) == 2          # K deduped, one per seed
    loopy = tfleet.plan_grid(_grids("loopy")[0])
    assert [c.mode for c in loopy.classes] == ["loop", "vmap", "vmap"]


def test_grid_errors_match_the_reference():
    dup = {"name": "dup", "base": TINY_BASE,
           "axes": [{"path": "method", "values": ["h-base", "h-base"]}]}
    with pytest.raises(ValueError, match="duplicate"):
        tfleet.SweepGrid.from_dict(dup).cells()
    bad = {"name": "bad", "base": {"train.bogus_knob": 1},
           "axes": [{"path": "seed", "values": [0]}]}
    with pytest.raises(KeyError, match="bogus_knob"):
        tfleet.SweepGrid.from_dict(bad).cells()


def test_inert_knob_normalization_preserves_the_trajectory():
    """The planner's normalizations leave the port's run unchanged:
    c-fedavg's K, and a non-re-clustering method's dropout threshold and
    MAML rates."""
    cells = {c.label: c.scenario for c in _tiny_grid(
        "norm", {"path": "method", "values": ["c-fedavg", "h-base"]},
        {"name": "knobs", "values": [
            {"label": "raw", "set": {"fleet.num_clusters": 3,
                                     "fleet.dropout_threshold": 0.9,
                                     "train.maml_alpha": 0.123}}]}).cells()}
    for raw in cells.values():
        eq = tfleet.equivalent_scenario(raw)
        assert eq != raw
        assert tfleet.compile_key(raw) == tfleet.compile_key(eq)
        a = tapi.run(raw, device="cpu")
        b = tapi.run(eq, device="cpu")
        assert a.to_history() == b.to_history()


def test_resume_runs_only_missing_cells_and_cli_is_a_noop(tmp_path,
                                                          capsys):
    from repro_torch.fleet.run import main as fleet_cli
    grid = _tiny_grid("resume", {"path": "seed", "values": [0, 1, 2]})
    store, report = tfleet.run_grid(grid, str(tmp_path), device="cpu",
                                    verbose=False)
    assert report["cells_run"] == 3
    assert [c["mode"] for c in report["classes"]] == ["vmap"]
    victim = sorted(store.completed())[0]
    os.remove(store.cell_path(victim))
    _, again = tfleet.run_grid(grid, str(tmp_path), device="cpu",
                               verbose=False)
    assert again["cells_run"] == 1 and again["cells_skipped"] == 2
    assert store.completed() == {c.key for c in grid.cells()}
    path = str(tmp_path / "grid.json")
    grid.save(path)
    c0 = COUNTERS.snapshot()
    assert fleet_cli([path, "--base-dir", str(tmp_path), "--device", "cpu",
                      "--query", "0.0"]) == 0
    d = Counters.delta(c0, COUNTERS.snapshot())
    assert d == {"fleet.cells.skipped": 3}
    out = capsys.readouterr().out
    assert "0 run / 3 skipped" in out and "t_to_acc_s" in out


def test_store_rejects_an_edited_grid_manifest(tmp_path):
    grid = _tiny_grid("guard", {"path": "seed", "values": [0]})
    store = tfleet.SweepStore.open(str(tmp_path), grid)
    gpath = os.path.join(store.root, "grid.json")
    with open(gpath) as f:
        d = json.load(f)
    d["name"] = "edited"
    with open(gpath, "w") as f:
        json.dump(d, f)
    with pytest.raises(ValueError, match="different grid"):
        tfleet.SweepStore.open(str(tmp_path), grid)
    with pytest.raises(FileNotFoundError, match="not a sweep directory"):
        tfleet.SweepStore.open_dir(str(tmp_path))


def test_exec_only_knobs_share_one_setup(tmp_path):
    """Four cells differing only in exec knobs: four loop classes (the
    reference's four compiles), one setup (one miss, three hits)."""
    grid = tfleet.SweepGrid.from_dict(GRIDS["exec-knobs"])
    plan = tfleet.plan_grid(grid)
    assert len(plan.setup_classes) == 1 and len(plan.classes) == 4
    c0 = COUNTERS.snapshot()
    store, report = tfleet.run_grid(grid, str(tmp_path), device="cpu",
                                    verbose=False)
    d = Counters.delta(c0, COUNTERS.snapshot())
    assert report["cells_run"] == 4
    assert d.get("api.setup_cache.miss") == 1
    assert d.get("api.setup_cache.hit") == 3
    loaded = store.load_all()
    with_telem = [r for r in loaded.values() if r.telemetry is not None]
    assert len(with_telem) == 2
    hist = {json.dumps(r.to_history()) for r in loaded.values()}
    assert len(hist) == 1      # microbatch and telemetry change nothing


def test_gated_class_builds_one_plan_and_cells_embed_their_manifest(
        tmp_path):
    grid = _tiny_grid(
        "gated", {"path": "method", "values": ["fedspace", "c-fedavg"]},
        {"path": "fleet.num_clusters", "values": [2, 3]},
        {"path": "seed", "values": [0, 1]})
    plan = tfleet.plan_grid(grid)
    assert tsmoke.expected_sharing(plan) == {
        "engine.plan_cache.miss": 2, "api.setup_cache.miss": 0}
    c0 = COUNTERS.snapshot()
    store, report = tfleet.run_grid(grid, str(tmp_path), device="cpu",
                                    verbose=False)
    d = Counters.delta(c0, COUNTERS.snapshot())
    assert report["cells_run"] == 8
    # two fedspace classes (K = 2, 3): one plan each, handed to 2 seeds
    assert d["engine.plan_cache.miss"] == 2
    assert d["engine.plan_cache.hit"] == 4
    assert d["fleet.cells.deduped"] == 2          # c-fedavg across K
    loaded = store.load_all()
    cfa = {(r.scenario.fleet.num_clusters, r.scenario.seed): r
           for r in loaded.values() if r.scenario.method == "c-fedavg"}
    assert sorted(cfa) == [(2, 0), (2, 1), (3, 0), (3, 1)]
    assert cfa[2, 0].to_history() == cfa[3, 0].to_history()
    single = tapi.run(cfa[3, 1].scenario, device="cpu")
    assert single.to_history() == cfa[3, 1].to_history()


def test_port_store_reads_in_the_reference_and_renders(tmp_path, capsys):
    grid = _tiny_grid("interop-port",
                      {"path": "method", "values": ["c-fedavg"]},
                      {"path": "fleet.num_clusters", "values": [2, 3]},
                      {"path": "seed", "values": [0, 1]})
    store, _ = tfleet.run_grid(grid, str(tmp_path), device="cpu",
                               verbose=False)
    jstore = jfleet.SweepStore.open_dir(store.root)
    assert jstore.grid().grid_hash() == grid.grid_hash()
    for target in (None, 0.0, 2.0):
        assert jstore.query(target_acc=target) == store.query(
            target_acc=target)
    rows = jstore.query(target_acc=0.0)
    assert len(rows) == 2 and all(r["cells"] == 2 for r in rows)
    assert all(r["round"] == 2 for r in rows)
    assert treport.main([store.root]) == 0
    out = capsys.readouterr().out
    assert "sweep report: interop-port" in out
    assert "cells: 4 completed of 4" in out
    assert jreport.main([store.root]) == 0
    assert "cells: 4 completed of 4" in capsys.readouterr().out


def test_reference_store_reads_in_the_port(tmp_path, capsys):
    grid = jfleet.SweepGrid.from_dict(
        {"name": "interop-ref", "base": TINY_BASE,
         "axes": [{"path": "seed", "values": [0, 1]}]})
    jstore, _ = jfleet.run_grid(grid, str(tmp_path), verbose=False)
    store = tfleet.SweepStore.open_dir(jstore.root)
    assert store.completed() == jstore.completed()
    assert store.query(target_acc=0.0) == jstore.query(target_acc=0.0)
    loaded = store.load_all()
    ref = jstore.load_all()
    for key, res in loaded.items():
        assert res.to_history() == ref[key].to_history()
        assert res.scenario.canonical_json() == (
            ref[key].scenario.canonical_json())
    # resuming the reference's directory in the port runs nothing
    _, report = tfleet.run_grid(tfleet.SweepGrid.from_dict(grid.to_dict()),
                                str(tmp_path), device="cpu", verbose=False)
    assert report["cells_run"] == 0 and report["cells_skipped"] == 2
    assert treport.main([jstore.root]) == 0
    assert "cells: 2 completed of 2" in capsys.readouterr().out


def test_render_sweep_shows_the_sharing_counters(tmp_path):
    grid = tfleet.SweepGrid.from_dict(GRIDS["exec-knobs"])
    store, _ = tfleet.run_grid(grid, str(tmp_path), device="cpu",
                               verbose=False)
    out = treport.render_sweep(store.root)
    assert "setup_cache.miss=1" in out and "setup_cache.hit=1" in out
    grid = _tiny_grid("plans", {"path": "method", "values": ["fedspace"]},
                      {"path": "seed", "values": [0, 1]})
    store, _ = tfleet.run_grid(grid, str(tmp_path), device="cpu",
                               verbose=False)
    out = treport.render_sweep(store.root)
    assert "plan_cache.hit=2, plan_cache.miss=1" in out


def test_fleet_smoke_gates_on_the_cpu(capsys):
    assert tsmoke.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "12 cells, 3 classes" in out
    assert "resume: 0 run / 12 skipped, no misses" in out
    assert "not applied on the CPU" in out


def test_sweep_row_results_equal_single_runs(tmp_path):
    """A vmap class's cells are the seed sweep's rows: each equals its
    own ``api.run``."""
    grid = _tiny_grid("rows", {"path": "method", "values": ["fedhc"]},
                      {"path": "seed", "values": [3, 4]})
    store, _ = tfleet.run_grid(grid, str(tmp_path), device="cpu",
                               verbose=False)
    for res in store.load_all().values():
        single = tapi.run(res.scenario, device="cpu")
        assert res.to_history() == single.to_history()
        np.testing.assert_array_equal(res.round, single.round)
