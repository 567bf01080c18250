"""The port's engines on a client mesh: W gloo ranks on the CPU, one
process a rank (`launch/mesh.py`, `core/aggregation_spmd.py`).

* W = 1: the history is the one-device history with ``==``, host reads
  included, through ``engine.simulate`` and ``api.run``; telemetry on
  equals off.
* W = 2 and 4: fedhc, h-base, c-fedavg, fedspace and fedhc-async at
  N = 32 meet the single-device port at the reference's sharded bar
  (``tests/test_sharded_engine.py:65-73``: re-clusters, stage-2 rounds and
  flushes exact, time and energy rtol 1e-5, loss rtol 1e-4 atol 1e-5,
  accuracy atol 5e-3); every rank returns the same history and holds
  C/W rows of each client-stacked leaf; the host reads are the
  single-device run's.
* W = 4 on the reference's inputs (`test_torch_jaxref`'s bridge) meets
  ``repro.core.engine.run(cfg, mesh=make_client_mesh())``, the JAX
  package's own sharded run over 8 XLA host devices in a subprocess, at
  the golden bar (fedhc, N = 32, K = 3).
* Under the mesh: ``api.run`` reports ``{"clients": W}``, telemetry on
  equals off, sliced and factorized plans, microbatching and its
  decomposition rule, and the divisibility and world-size errors.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

from repro.core.fedhc import FLRunConfig as JaxConfig

from test_torch_jaxref import reference_draws, reference_setup
from torch_ranks import Ranks

from repro_torch.core import engine as tengine
from repro_torch.core import strategies as tstrat
from repro_torch.core.fedhc import FLRunConfig

CFG = dict(num_clients=32, num_clusters=3, rounds=8, rounds_per_global=4,
           eval_every=4, samples_per_client=32, local_steps=1,
           eval_size=128, batch_size=16)
METHODS = ("fedhc", "h-base", "c-fedavg", "fedspace", "fedhc-async")
EXTRA = {"fedhc-async": dict(async_cohort=8, async_buffer=8),
         "fedhc-async-full": dict(method="fedhc-async"),
         "fedspace-sliced": dict(method="fedspace", contact_slices=True),
         "fedspace-factorized": dict(method="fedspace",
                                     contact_factorized=True),
         "fedhc-mb8": dict(method="fedhc", client_microbatch=8)}


W2_CASES = METHODS + ("fedhc-async-full", "fedspace-factorized")
W4_CASES = METHODS + ("fedspace-sliced", "fedhc-mb8")


def _cfg(name):
    kw = dict(CFG, method=name)
    kw.update(EXTRA.get(name, {}))
    return kw


def _history(cfg_kw):
    cfg = FLRunConfig(**cfg_kw)
    tengine.reset_host_reads()
    h = tengine.run(cfg, device="cpu")
    return h, dict(tengine.HOST_READS)


RUNS = """
from repro_torch import api
from repro_torch.core import async_engine, engine
from repro_torch.core import strategies as strat
from repro_torch.core.fedhc import FLRunConfig
from repro_torch.tree import tree_leaves

def mesh_run(kw):
    cfg = FLRunConfig(**kw)
    eng = async_engine if strat.get(cfg.method).is_async else engine
    state0, data = eng.setup(cfg, device="cpu", mesh=mesh)
    stack = (state0.work_params if strat.get(cfg.method).is_async
             else state0.params)
    engine.reset_host_reads()
    _, outs = engine.simulate(cfg, device="cpu", state0=state0, data=data,
                              mesh=mesh)
    return {"h": eng.history_from_outputs(outs),
            "reads": dict(engine.HOST_READS),
            "rows": sorted({x.shape[0] for x in tree_leaves(stack)})}

for name, kw in CASES.items():
    result[name] = mesh_run(kw)
"""

ONE_RANK = """
for name, kw in CASES.items():
    cfg = FLRunConfig(**kw)
    engine.reset_host_reads()
    h = engine.run(cfg, device="cpu")
    assert result[name]["h"] == h, (name, result[name]["h"], h)
    assert result[name]["reads"] == dict(engine.HOST_READS), name
sc = api.Scenario.from_flat(FLRunConfig(**CASES["fedhc"]), mesh_devices=1)
off = api.run(sc, device="cpu")
on = api.run(sc.replace(exec=api.ExecSpec(mesh_devices=1, telemetry=True)),
             device="cpu")
single = api.run(sc.replace(exec=api.ExecSpec()), device="cpu")
assert off.to_history() == on.to_history() == single.to_history()
assert off.mesh_shape == {"clients": 1} and single.mesh_shape is None
result["api"] = "ok"
"""

FOUR_RANKS = """
import dataclasses
# api.run under the mesh: the ExecSpec's mesh, telemetry on == off
sc = api.Scenario.from_flat(FLRunConfig(**CASES["fedhc"]), mesh_devices=0)
cache = {}
off = api.run(sc, device="cpu", setup_cache=cache)
on = api.run(sc.replace(exec=api.ExecSpec(mesh_devices=0, telemetry=True)),
             device="cpu", setup_cache=cache)
assert off.to_history() == on.to_history()
t = on.telemetry.rounds
assert t["cohort_size"].shape == (8,) and (t["cohort_size"] == 32).all()
assert t["cluster_fill"].shape == (8, 3)
result["api"] = {"mesh": off.mesh_shape, "hist": off.to_history(),
                 "accepted": t["accepted"].tolist()}
# the errors: a non-decomposable microbatch, an indivisible N, a mesh
# that is not the world
errors = {}
for key, call in (
        ("microbatch", lambda: engine.run(FLRunConfig(
            **dict(CASES["fedhc"], client_microbatch=6)), device="cpu",
            mesh=mesh)),
        ("divisible", lambda: engine.setup(FLRunConfig(
            **dict(CASES["fedhc"], num_clients=30)), device="cpu",
            mesh=mesh)),
        ("world", lambda: mesh_lib.make_client_mesh(3, device_type="cpu"))):
    try:
        call()
        errors[key] = None
    except ValueError as e:
        errors[key] = str(e)
result["errors"] = errors
# the reference's inputs, handed over by the parent
npz = np.load(os.environ["BRIDGE_NPZ"])
arrays = {k: npz[k] for k in npz.files if "/" not in k}
arrays["w0"] = {}
for k in npz.files:
    if k.startswith("w0/"):
        _, layer, leaf = k.split("/")
        arrays["w0"].setdefault(layer, {})[leaf] = npz[k]
cfg = FLRunConfig(**CASES["fedhc"])
state0, data = engine.state_from_numpy(cfg, arrays, device="cpu",
                                       mesh=mesh)
draws = engine.ArrayDraws(npz["draw_batch"], npz["draw_kmeans"],
                          npz["draw_central"], device="cpu")
_, outs = engine.simulate(cfg, device="cpu", state0=state0, data=data,
                          draws=draws, mesh=mesh)
result["bridged"] = engine.history_from_outputs(outs)
"""

JAX_SHARDED = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    jax.config.update("jax_threefry_partitionable", True)
    from repro.core import engine
    from repro.core.fedhc import FLRunConfig
    from repro.launch.mesh import make_client_mesh
    assert len(jax.devices()) == 8
    cfg = FLRunConfig(**json.loads(sys.argv[1]))
    print(json.dumps(engine.run(cfg, mesh=make_client_mesh())))
""")


def _assert_sharded_bar(h, want):
    """The reference's sharded-vs-single bar."""
    assert h["round"] == want["round"]
    for key in ("reclusters", "global_rounds", "flushes"):
        assert h.get(key) == want.get(key), key
    np.testing.assert_allclose(h["time_s"], want["time_s"], rtol=1e-5)
    np.testing.assert_allclose(h["energy_j"], want["energy_j"], rtol=1e-5)
    np.testing.assert_allclose(h["loss"], want["loss"], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(h["acc"], want["acc"], atol=5e-3)


def _assert_golden_bar(h, want):
    assert h["round"] == want["round"]
    assert h["reclusters"] == want["reclusters"]
    np.testing.assert_allclose(h["time_s"], want["time_s"], rtol=1e-5)
    np.testing.assert_allclose(h["energy_j"], want["energy_j"], rtol=1e-5)
    np.testing.assert_allclose(h["loss"], want["loss"], rtol=1e-3,
                               atol=1e-5)
    np.testing.assert_allclose(h["acc"], want["acc"], atol=5e-3)


def _body(cases, extra=""):
    return f"CASES = {cases!r}\n" + RUNS + extra


def _bridge_npz(path):
    """The reference's setup and draws for fedhc at CFG, as one .npz."""
    jcfg = JaxConfig(method="fedhc", **CFG)
    with jax.threefry_partitionable(True):
        arrays, jstate0, jdata = reference_setup(jcfg)
        batch, kinit, central = reference_draws(jcfg, jstate0, jdata)
    flat = {k: v for k, v in arrays.items() if k != "w0"}
    for layer, leaves in arrays["w0"].items():
        for leaf, v in leaves.items():
            flat[f"w0/{layer}/{leaf}"] = np.asarray(v)
    np.savez(path, draw_batch=batch, draw_kmeans=kinit,
             draw_central=central, **flat)


@pytest.fixture(scope="module")
def w1(tmp_path_factory):
    cases = {m: _cfg(m) for m in ("fedhc", "fedspace", "fedhc-async",
                                  "c-fedavg")}
    return Ranks(1, _body(cases, ONE_RANK), tmp_path_factory.mktemp("w1"),
                 tag="w1").wait()


@pytest.fixture(scope="module")
def w2(tmp_path_factory):
    cases = {m: _cfg(m) for m in W2_CASES}
    ranks = Ranks(2, _body(cases), tmp_path_factory.mktemp("w2"), tag="w2")
    single = {m: _history(kw) for m, kw in cases.items()}
    return ranks.wait(), single


@pytest.fixture(scope="module")
def w4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("w4")
    npz = str(tmp / "bridge.npz")
    _bridge_npz(npz)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in ["src", os.environ.get("PYTHONPATH")] if p))
    jax_run = subprocess.Popen(
        [sys.executable, "-c", JAX_SHARDED, json.dumps(_cfg("fedhc"))],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    cases = {m: _cfg(m) for m in W4_CASES}
    os.environ["BRIDGE_NPZ"] = npz
    try:
        ranks = Ranks(4, _body(cases, FOUR_RANKS), tmp, tag="w4")
    finally:
        del os.environ["BRIDGE_NPZ"]
    single = {m: _history(kw) for m, kw in cases.items()}
    try:
        out, err = jax_run.communicate(timeout=600)
    finally:
        if jax_run.poll() is None:
            jax_run.kill()
    assert jax_run.returncode == 0, err[-3000:]
    return ranks.wait(), single, json.loads(out.strip().splitlines()[-1])


def test_one_rank_is_the_single_device_run(w1):
    """W = 1: ``==`` with the one-device history and host reads (checked
    in the rank), for the sync, gated, async and replicated paths, and
    through ``api.run`` with telemetry on and off."""
    (rank,) = w1
    assert rank["api"] == "ok"
    for name in ("fedhc", "fedspace", "fedhc-async"):
        assert rank[name]["rows"] == [32]


@pytest.mark.parametrize("method", W2_CASES)
def test_two_ranks_match_single_device(w2, method):
    ranks, single = w2
    h, reads = single[method]
    for r in ranks:
        assert r[method]["h"] == ranks[0][method]["h"]
        assert r[method]["reads"] == reads
        # c-fedavg's state is replicated, its one model unstacked
        if tstrat.get(_cfg(method)["method"]).shardable:
            assert r[method]["rows"] == [16]
    _assert_sharded_bar(ranks[0][method]["h"], h)


@pytest.mark.parametrize("method", W4_CASES)
def test_four_ranks_match_single_device(w4, method):
    ranks, single, _ = w4
    h, reads = single[method]
    for r in ranks:
        assert r[method]["h"] == ranks[0][method]["h"]
        assert r[method]["reads"] == reads
        if tstrat.get(_cfg(method)["method"]).shardable:
            assert r[method]["rows"] == [8]
    _assert_sharded_bar(ranks[0][method]["h"], h)
    if method in ("fedhc", "fedspace", "fedhc-async"):
        assert (h["reclusters"] + h["global_rounds"]
                + h.get("flushes", 0)) >= 1


def test_four_ranks_meet_the_reference_sharded_run(w4):
    """The port on 4 gloo ranks, fed the reference's setup and draws,
    against the JAX package's sharded run on 8 host devices."""
    ranks, _, jax_sharded = w4
    for r in ranks:
        assert r["bridged"] == ranks[0]["bridged"]
    assert jax_sharded["reclusters"] >= 1
    _assert_golden_bar(ranks[0]["bridged"], jax_sharded)


def test_api_run_on_the_mesh(w4):
    """``ExecSpec(mesh_devices=0)`` runs on every rank alike; telemetry on
    equals off there (checked in the ranks); the errors are the
    reference's."""
    ranks, single, _ = w4
    for r in ranks:
        assert r["api"]["mesh"] == {"clients": 4}
        assert r["api"] == ranks[0]["api"]
        errors = r["errors"]
        assert "client_microbatch" in errors["microbatch"]
        assert "divisible" in errors["divisible"]
        assert "world size 4" in errors["world"]
    _assert_sharded_bar(ranks[0]["api"]["hist"], single["fedhc"][0])
