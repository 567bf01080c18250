"""The port's sync round engine and API against the JAX reference.

* Golden parity: with the reference's setup and draws handed over
  (`test_torch_jaxref.bridged`), the port reproduces
  ``tests/golden/engine_always.json`` for the five paper methods at the
  bar of ``tests/test_connectivity.py``: round list and re-cluster count
  exact, time and energy rtol 1e-5, loss rtol 1e-3, accuracy atol 5e-3.
* Kernel-flag parity: ``use_pallas_kernels`` on and off agree.
* ``Scenario`` JSON and content hashes equal the reference's; ``api.run``
  returns a full ``RunResult``; the port imports nothing of JAX.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import strategies as jstrat

from repro_torch import api as tapi
from repro_torch import device as device_lib
from repro_torch.core import engine as tengine
from repro_torch.core import strategies as tstrat
from repro_torch.core.fedhc import FLRunConfig

from test_torch_jaxref import bridged

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden", "engine_always.json")
GOLDEN_CFG = dict(num_clients=16, num_clusters=3, rounds=20, eval_every=5,
                  samples_per_client=64, local_steps=2, eval_size=256)
# the reference's kernel-flag parity setting (tests/test_kernels.py:143),
# with the golden config's data shapes so the reference's setup compiles once
FLAG_CFG = dict(GOLDEN_CFG, method="fedhc", rounds=8, rounds_per_global=4,
                eval_every=4, local_steps=1, batch_size=16,
                dropout_threshold=0.2, round_minutes=4.0)


def _assert_trajectory(h, want, loss_rtol=1e-3):
    assert h["round"] == want["round"]
    assert h["reclusters"] == want["reclusters"]
    np.testing.assert_allclose(h["time_s"], want["time_s"], rtol=1e-5)
    np.testing.assert_allclose(h["energy_j"], want["energy_j"], rtol=1e-5)
    np.testing.assert_allclose(h["loss"], want["loss"], rtol=loss_rtol,
                               atol=1e-5)
    np.testing.assert_allclose(h["acc"], want["acc"], atol=5e-3)


def _run_bridged(golden_streams=False, **cfg):
    tcfg, state0, data, draws, jcfg = bridged(golden_streams=golden_streams,
                                              **cfg)
    _, outs = tengine.simulate(tcfg, device="cpu", state0=state0, data=data,
                               draws=draws)
    return tengine.history_from_outputs(outs), jcfg


@pytest.mark.parametrize("method", tstrat.PAPER_METHODS)
def test_golden_parity_from_bridged_inputs(method):
    with open(GOLDEN) as f:
        golden = json.load(f)[method]
    h, _ = _run_bridged(golden_streams=True, method=method, **GOLDEN_CFG)
    _assert_trajectory(h, golden)


def test_kernel_flag_parity():
    """The flag routes the drift check and every stage-1 (the re-cluster
    branch's too) through ``kernels/ops``; on the CPU that is the plain
    versions, so on and off agree, re-clustering on the same rounds (the
    CUDA kernels are held to the same bar on the card by chip_smoke.py)."""
    tcfg, state0, data, draws, _ = bridged(golden_streams=True, **FLAG_CFG)
    hist = {}
    for on in (True, False):
        cfg = dataclasses.replace(tcfg, use_pallas_kernels=on)
        _, outs = tengine.simulate(cfg, device="cpu", state0=state0,
                                   data=data, draws=draws)
        hist[on] = tengine.history_from_outputs(outs)
    h_on, h_off = hist[True], hist[False]
    assert h_on["reclusters"] == h_off["reclusters"] >= 1
    _assert_trajectory(h_on, h_off, loss_rtol=1e-4)


def test_api_run_gives_a_full_run_result():
    sc = tapi.Scenario(
        method="fedhc",
        data=tapi.DataSpec(samples_per_client=32, eval_size=64),
        fleet=tapi.FleetSpec(num_clients=8, num_clusters=2,
                             dropout_threshold=0.0, round_minutes=4.0),
        train=tapi.TrainSpec(rounds=4, rounds_per_global=2, eval_every=2,
                             local_steps=1, batch_size=8),
        exec=tapi.ExecSpec(use_pallas_kernels=True))
    res = tapi.run(sc, device="cpu")
    fields = {f.name for f in dataclasses.fields(japi.RunResult)}
    assert fields == {f.name for f in dataclasses.fields(tapi.RunResult)}
    assert res.round.tolist() == [2, 4]
    for key in ("acc", "loss", "time_s", "energy_j"):
        assert np.all(np.isfinite(getattr(res, key)))
    assert res.reclusters >= 1 and res.global_rounds == 2
    assert res.strategy == dataclasses.asdict(jstrat.get("fedhc"))
    assert res.mesh_shape is None and res.peak_device_mem_mb is None
    assert res.compile_s == 0.0 and res.setup_s > 0 and res.run_s > 0
    assert res.to_history()["round"] == [2, 4]
    # native draws: a run is a function of its seed
    again = tapi.run(sc, device="cpu")
    assert again.to_history() == res.to_history()
    other = tapi.run(sc.replace(seed=1), device="cpu")
    assert other.to_history() != res.to_history()


@pytest.mark.parametrize("method", jstrat.names())
def test_scenario_json_and_hash_equal_the_reference(method):
    kw = dict(method=method, seed=3)
    jsc = japi.Scenario(**kw, fleet=japi.FleetSpec(num_clients=32),
                        exec=japi.ExecSpec(use_pallas_kernels=True))
    tsc = tapi.Scenario(**kw, fleet=tapi.FleetSpec(num_clients=32),
                        exec=tapi.ExecSpec(use_pallas_kernels=True))
    assert tsc.canonical_json() == jsc.canonical_json()
    assert tsc.content_hash() == jsc.content_hash()
    assert tapi.Scenario.from_json(jsc.to_json()) == tsc
    assert (dataclasses.asdict(tstrat.get(method))
            == dataclasses.asdict(jstrat.get(method)))
    assert tsc.to_flat() == FLRunConfig(**{
        f.name: getattr(jsc.to_flat(), f.name)
        for f in dataclasses.fields(FLRunConfig) if f.name != "dataset"},
        dataset=tsc.data.dataset)


def _sweep_async():
    tapi.run_sweep(tapi.Scenario(method="fedhc-async"), (0, 1),
                   device="cpu")


def _async_factorized():
    tengine.setup(FLRunConfig(method="fedspace-async", num_clients=8,
                              contact_factorized=True), device="cpu")


def _sweep_mesh():
    tapi.run_sweep(tapi.Scenario(exec=tapi.ExecSpec(mesh_devices=0)), (0, 1),
                   device="cpu")


def _async_telemetry():
    _, (outs, telem) = tengine.simulate(
        FLRunConfig(method="fedbuff", num_clients=8, num_clusters=2,
                    rounds=2, eval_every=2, samples_per_client=16,
                    batch_size=8, local_steps=1, eval_size=64,
                    async_cohort=4, telemetry=True), device="cpu")
    assert telem.cohort_size.tolist() == [4, 4]
    assert outs.flushes.tolist() == telem.flushes.tolist()


def _transformer_train():
    from repro_torch.launch import train
    res = train.train(rounds=1, device="cpu", smoke=True)
    assert len(res.rounds) == 1 and np.isfinite(res.rounds[0].ce)


def _train_dry_run():
    from repro_torch.launch import train
    train.main(["--dry-run", "--smoke", "--device", "cpu"])


@pytest.mark.parametrize("call,exc,match", [
    (_sweep_async, ValueError, "sync-only"),
    (_async_factorized, ValueError, "sync-engine-only"),
    (_async_telemetry, None, None),
    (_sweep_mesh, ValueError, "client mesh"),
    (_transformer_train, None, None),
    (_train_dry_run, None, None),
], ids=["run_sweep-async", "async-factorized", "async-telemetry",
        "run_sweep-mesh", "transformer-train", "train-dry-run"])
def test_other_engines_name_their_roadmap_slice(call, exc, match):
    """What the engines still refuse, with the reference's errors: a seed
    sweep of an async method, per-client-clock routing on a factorized
    plan, and a seed sweep on a client mesh (slice 12 ported the mesh for
    ``api.run``; the reference's ``run_sweep`` refuses one too).
    Telemetry (slice 13) is ported: that case runs (``exc`` None) and
    returns the reference's ``(AsyncOutput, Telemetry)`` pair.  Transformer
    training (slice 16) is ported: a smoke round of the launcher runs, and
    so does its dry run (slice 16b: the round step counted on fake
    tensors)."""
    if exc is None:
        call()
        return
    with pytest.raises(exc, match=match):
        call()


MESH_RUN = """
from repro_torch import api
sc = api.Scenario(
    data=api.DataSpec(samples_per_client=16, eval_size=64),
    fleet=api.FleetSpec(num_clients=8, num_clusters=2),
    train=api.TrainSpec(rounds=2, eval_every=2, local_steps=1, batch_size=8),
    exec=api.ExecSpec(mesh_devices=1))
res = api.run(sc, device="cpu")
result["mesh_shape"] = res.mesh_shape
result["same"] = (res.to_history() == api.run(
    sc.replace(exec=api.ExecSpec()), device="cpu").to_history())
"""


def test_mesh_and_telemetry_are_not_ported_yet(tmp_path):
    """Both, once refused here, now run.  The client mesh (slice 12):
    ``ExecSpec(mesh_devices=...)`` raises without a process group (naming
    ``init_process_group``, never running unsharded in silence) and runs
    in one (here one gloo rank: the one-device history, ``mesh_shape``
    ``{"clients": 1}``).  Telemetry (slice 13): the sync engine returns
    the reference's ``(RoundOutput, Telemetry)`` pair, one row a round."""
    from torch_ranks import run_ranks
    sc = tapi.Scenario(exec=tapi.ExecSpec(mesh_devices=0))
    with pytest.raises(RuntimeError, match="init_process_group"):
        tapi.run(sc, device="cpu")
    (rank,) = run_ranks(1, MESH_RUN, tmp_path, tag="mesh")
    assert rank == {"mesh_shape": {"clients": 1}, "same": True}
    cfg = FLRunConfig(method="h-base", num_clients=8, num_clusters=2,
                      rounds=3, eval_every=3, samples_per_client=16,
                      batch_size=8, local_steps=1, eval_size=64,
                      telemetry=True)
    _, pair = tengine.simulate(cfg, device="cpu")
    outs, telem = tengine.split_outputs(pair)
    assert type(outs) is tengine.RoundOutput
    assert telem.flushes.tolist() == [2, 2, 2]
    assert telem.cluster_fill.shape == (3, 2)
    assert tengine.history_from_outputs(pair) == tengine.history_from_outputs(
        tengine.simulate(dataclasses.replace(cfg, telemetry=False),
                         device="cpu")[1])


def test_cuda_is_the_default_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device_lib.resolve(None)
    with pytest.raises(RuntimeError, match="no CUDA"):
        tapi.run(tapi.Scenario(), device=None)
    assert device_lib.resolve("cpu") == torch.device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_port_and_chip_smoke_import_nothing_of_jax():
    """Every module of the port, and chip_smoke, in a fresh interpreter:
    neither ``jax`` nor the reference package ``repro`` gets imported."""
    code = """
import importlib, pkgutil, sys
sys.path.insert(0, "src"); sys.path.insert(0, ".")
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
sys.path.insert(0, "examples")
for name in names + ["chip_smoke", "quickstart_torch", "fl_transformer_torch"]:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
assert len(names) >= 20, names
print("ok", len(names))
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.startswith("ok")


def test_chip_smoke_alone_exits_nonzero_and_prints_no_result(tmp_path):
    """In a directory that holds chip_smoke.py and nothing else of the
    repository it exits non-zero and prints no result (here it also finds
    no CUDA device)."""
    import shutil
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
