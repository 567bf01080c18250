"""The port's support modules against the JAX reference:

* ``core/scheduler``: the legacy host gate equals the reference's, and
  equals the port's contact plan sample for sample (the case of
  ``tests/test_scheduler_pipeline.py:33``);
* ``data/pipeline``: tokens equal the reference's for the same seed, and
  on a client mesh each rank gets its own rows;
* ``optim``: SGD (momentum, weight decay) and Adam track the reference
  within 1e-6 over 10 steps on the same arrays;
* ``checkpoint``: a file either package writes restores in the other,
  bf16 leaves included, and on a mesh each rank keeps its rows;
* ``fedhc.run_fl_legacy``: the host-loop oracle meets the port's engine
  on the same draws at the golden bar for the five paper methods.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.core import scheduler as jsched
from repro.data import pipeline as jpipe
from repro.optim import optimizers as jopt
from repro.orbits.constellation import Constellation as JConstellation

from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.core import engine as tengine
from repro_torch.core import scheduler as tsched
from repro_torch.core import strategies as tstrat
from repro_torch.core.fedhc import FLRunConfig, run_fl_legacy
from repro_torch.data import pipeline as tpipe
from repro_torch.optim import optimizers as topt
from repro_torch.orbits import contact as tcontact
from repro_torch.orbits.constellation import Constellation
from repro_torch.orbits.links import LinkParams

from test_torch_jaxref import bridged
from torch_ranks import run_ranks

# ------------------------------------------------------------- scheduler --


def test_scheduler_cadence_and_gate_match_reference():
    sch_j, sch_t = jsched.Schedule(rounds_per_global=5), \
        tsched.Schedule(rounds_per_global=5)
    cj, ct = JConstellation(8, 8), Constellation(8, 8)
    ps = list(range(0, 64, 4))
    for rnd in (0, 3, 4, 9):
        for t in (0.0, 600.0, 1200.0, 2345.5):
            want = jsched.should_aggregate_globally(sch_j, rnd, cj, t, ps)
            got = tsched.should_aggregate_globally(sch_t, rnd, ct, t, ps,
                                                   device="cpu")
            assert got == want, (rnd, t, got, want)
    hits = [bool(tsched.ground_stage_allowed(ct, t, [0, 5, 10],
                                             device="cpu"))
            for t in np.linspace(0.0, 7000.0, 40)]
    assert hits == [bool(jsched.ground_stage_allowed(cj, float(t),
                                                     [0, 5, 10]))
                    for t in np.linspace(0.0, 7000.0, 40)]
    assert any(hits) and not all(hits)


def test_legacy_gate_agrees_with_contact_plan():
    """The host gate and the port's contact plan are one predicate: at
    every plan sample, for the same mask and PS set, they agree."""
    c = Constellation(num_planes=4, sats_per_plane=4)
    plan = tcontact.build_contact_plan(c, LinkParams(), dt_s=300.0,
                                       min_elevation_deg=10.0, device="cpu")
    ps = torch.tensor([0, 5, 10])
    for i in range(plan.times.shape[0]):
        t = plan.times[i]
        legacy = bool(tsched.ground_stage_allowed(c, t, ps,
                                                  min_elevation_deg=10.0))
        vis_row, _, _ = tcontact.lookup(plan, t)
        assert legacy == bool(vis_row[ps].any()), (i, float(t))


# -------------------------------------------------------------- pipeline --


def test_pipeline_tokens_equal_the_reference():
    front = {"pixels": (3, 4)}
    it_j = jpipe.batches(seed=3, n_clients=4, pcb=2, seq=16, vocab=1000,
                         frontend=front)
    it_t = tpipe.batches(seed=3, n_clients=4, pcb=2, seq=16, vocab=1000,
                         frontend=front, device="cpu")
    for _ in range(3):
        bj, bt = next(it_j), next(it_t)
        assert set(bj) == set(bt)
        for key in ("tokens", "labels"):
            assert bt[key].dtype == torch.int32
            np.testing.assert_array_equal(bt[key].numpy(),
                                          np.asarray(bj[key]))
        assert bt["pixels"].shape == (4, 2, 3, 4)
        assert bt["pixels"].dtype == torch.bfloat16
    assert torch.equal(bt["tokens"][:, :, 1:], bt["labels"][:, :, :-1])


# ----------------------------------------------------------------- optim --


def _quad_grads(steps, seed=0):
    g = np.random.default_rng(seed)
    return [{"w": g.standard_normal((3, 4)).astype(np.float32),
             "b": g.standard_normal((4,)).astype(np.float32)}
            for _ in range(steps)]


@pytest.mark.parametrize("name,kw", [
    ("sgd", dict(lr=0.05)),
    ("sgd", dict(lr=0.05, momentum=0.9)),
    ("sgd", dict(lr=0.05, momentum=0.9, weight_decay=0.01)),
    ("adam", dict(lr=0.01)),
    ("adam", dict(lr=0.01, weight_decay=0.01)),
], ids=["sgd", "momentum", "momentum-wd", "adam", "adam-wd"])
def test_optimizers_track_the_reference(name, kw):
    g = np.random.default_rng(1)
    p0 = {"w": g.standard_normal((3, 4)).astype(np.float32),
          "b": g.standard_normal((4,)).astype(np.float32)}
    init_j, upd_j = jopt.make_optimizer(name, **kw)
    init_t, upd_t = topt.make_optimizer(name, **kw)
    pj = {k: jnp.asarray(v) for k, v in p0.items()}
    pt = {k: torch.as_tensor(v) for k, v in p0.items()}
    sj, st = init_j(pj), init_t(pt)
    for grads in _quad_grads(10):
        pj, sj = upd_j(pj, {k: jnp.asarray(v) for k, v in grads.items()},
                       sj)
        pt, st = upd_t(pt, {k: torch.as_tensor(v)
                            for k, v in grads.items()}, st)
    assert int(st.step) == int(sj.step) == 10
    for k in p0:
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]),
                                   rtol=0, atol=1e-6)
        if name == "adam" or kw.get("momentum"):
            np.testing.assert_allclose(st.m[k].numpy(), np.asarray(sj.m[k]),
                                       rtol=0, atol=1e-6)


def test_optimizer_updates_a_client_stack():
    """Elementwise: one call updates every client of a (C, ...) stack as
    C separate calls would."""
    g = np.random.default_rng(2)
    stack = {"w": torch.as_tensor(g.standard_normal((5, 3)),
                                  dtype=torch.float32)}
    grads = {"w": torch.as_tensor(g.standard_normal((5, 3)),
                                  dtype=torch.float32)}
    out, _ = topt.adam_update(stack, grads, topt.adam_init(stack), lr=0.1)
    for c in range(5):
        one, _ = topt.adam_update({"w": stack["w"][c]}, {"w": grads["w"][c]},
                                  topt.adam_init({"w": stack["w"][c]}),
                                  lr=0.1)
        torch.testing.assert_close(out["w"][c], one["w"], rtol=0, atol=0)


# ------------------------------------------------------------ checkpoint --


def _tree_j():
    return {"layers": ({"w": jnp.arange(6.0).reshape(2, 3),
                        "b": (jnp.arange(3) / 7).astype(jnp.bfloat16)},
                       {"w": jnp.ones((2, 2)), "b": None}),
            "step_info": {"count": jnp.asarray(7, jnp.int32)},
            "seq": [jnp.zeros((1,), jnp.float32)]}


def _tree_t():
    return {"layers": ({"w": torch.arange(6.0).reshape(2, 3),
                        "b": (torch.arange(3) / 7).to(torch.bfloat16)},
                       {"w": torch.ones((2, 2)), "b": None}),
            "step_info": {"count": torch.tensor(7, dtype=torch.int32)},
            "seq": [torch.zeros((1,))]}


def _check_same(t_tree, j_tree):
    assert isinstance(t_tree["layers"], tuple) and \
        isinstance(j_tree["layers"], tuple)
    assert isinstance(t_tree["seq"], list) and isinstance(j_tree["seq"],
                                                          list)
    assert t_tree["layers"][1]["b"] is None
    assert j_tree["layers"][1]["b"] is None
    bt, bj = t_tree["layers"][0]["b"], j_tree["layers"][0]["b"]
    assert bt.dtype == torch.bfloat16 and str(bj.dtype) == "bfloat16"
    np.testing.assert_array_equal(bt.view(torch.int16).numpy(),
                                  np.asarray(bj).view(np.int16))
    for path in (("layers", 0, "w"), ("layers", 1, "w"),
                 ("step_info", "count")):
        a, b = t_tree, j_tree
        for key in path:
            a, b = a[key], b[key]
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert str(a.dtype).removeprefix("torch.") == np.asarray(b).dtype.name


def test_checkpoint_crosses_packages(tmp_path):
    """The reference writes, the port restores; the port writes, the
    reference restores: same keys, structure and dtypes, bf16 included."""
    jpath, tpath = str(tmp_path / "j" / "ckpt"), str(tmp_path / "t" / "ckpt")
    jckpt.save(jpath, _tree_j(), step=42)
    tckpt.save(tpath, _tree_t(), step=42)
    got_t, step_t = tckpt.restore(jpath, device="cpu")
    got_j, step_j = jckpt.restore(tpath)
    assert step_t == step_j == 42
    _check_same(got_t, _tree_j())
    _check_same(_tree_t(), got_j)
    with np.load(jpath + ".npz") as a, np.load(tpath + ".npz") as b:
        assert sorted(a.files) == sorted(b.files)
    with open(jpath + ".meta.json") as a, open(tpath + ".meta.json") as b:
        assert a.read() == b.read()


MESH_BODY = """
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.data import pipeline
from repro_torch.sharding import rules
it = pipeline.batches(seed=5, n_clients=4, pcb=2, seq=8, vocab=500,
                      mesh=mesh, device="cpu")
result["tokens"] = next(it)["tokens"].tolist()
stack, _ = ckpt.restore(os.environ["CKPT"], device="cpu")
specs = rules.tree_param_specs(stack, mesh, client_axes=("clients",),
                               client_stacked=True)
local, _ = ckpt.restore(os.environ["CKPT"], mesh=mesh,
                        placements=rules.tree_shardings(specs, mesh),
                        device="cpu")
result["w"] = local["w"].tolist()
result["b"] = local["b"].float().tolist()
"""


def test_pipeline_and_checkpoint_rows_on_a_mesh(tmp_path):
    g = np.random.default_rng(3)
    stack = {"w": torch.as_tensor(g.standard_normal((4, 3, 2)),
                                  dtype=torch.float32),
             "b": torch.as_tensor(g.standard_normal((4, 5))).to(
                 torch.bfloat16)}
    path = str(tmp_path / "stack")
    tckpt.save(path, stack)
    os.environ["CKPT"] = path
    try:
        ranks = run_ranks(2, MESH_BODY, tmp_path, tag="support")
    finally:
        del os.environ["CKPT"]
    want = np.asarray(next(jpipe.batches(seed=5, n_clients=4, pcb=2, seq=8,
                                         vocab=500))["tokens"])
    for r, res in enumerate(ranks):
        rows = slice(2 * r, 2 * r + 2)
        np.testing.assert_array_equal(np.asarray(res["tokens"]), want[rows])
        np.testing.assert_array_equal(np.asarray(res["w"], np.float32),
                                      stack["w"][rows].numpy())
        np.testing.assert_array_equal(np.asarray(res["b"], np.float32),
                                      stack["b"][rows].float().numpy())


# ---------------------------------------------------------------- legacy --

LEGACY_CFG = dict(num_clients=16, num_clusters=3, rounds=10, eval_every=5,
                  samples_per_client=32, local_steps=1, eval_size=256,
                  batch_size=16, round_minutes=4.0, dropout_threshold=0.2)


def _golden_bar(h, want):
    assert h["round"] == want["round"]
    assert h["reclusters"] == want["reclusters"]
    np.testing.assert_allclose(h["time_s"], want["time_s"], rtol=1e-5)
    np.testing.assert_allclose(h["energy_j"], want["energy_j"], rtol=1e-5)
    np.testing.assert_allclose(h["loss"], want["loss"], rtol=1e-3,
                               atol=1e-5)
    np.testing.assert_allclose(h["acc"], want["acc"], atol=5e-3)


@pytest.mark.parametrize("method", tstrat.PAPER_METHODS)
def test_legacy_loop_meets_the_engine(method):
    """Native draws: the same ``TorchDraws`` for both."""
    cfg = FLRunConfig(method=method, **LEGACY_CFG)
    legacy = run_fl_legacy(cfg, device="cpu")
    want = tengine.run(cfg, device="cpu")
    assert "global_rounds" not in legacy
    _golden_bar(legacy, want)
    if method in ("fedhc", "fedhc-nomaml"):
        assert legacy["reclusters"] >= 1


def test_legacy_loop_meets_the_engine_on_reference_draws():
    """Bridged: the reference's setup and draws (``ArrayDraws``)."""
    tcfg, state0, data, draws, _ = bridged(method="fedhc", **LEGACY_CFG)
    legacy = run_fl_legacy(tcfg, device="cpu", state0=state0, data=data,
                           draws=draws)
    _, outs = tengine.simulate(tcfg, device="cpu", state0=state0, data=data,
                               draws=draws)
    _golden_bar(legacy, tengine.history_from_outputs(outs))
    with pytest.raises(ValueError, match="paper methods"):
        run_fl_legacy(FLRunConfig(method="fedspace"), device="cpu")
