"""MAML (Eq. 16-17, §III-C), the ``cluster_init`` registry decorator and
the port's constellation demo, against the JAX reference.

Every case feeds the same inputs, drawn with numpy from a seed, to both
packages:

* ``inner_adapt``'s output, and the gradient of a query loss of it with
  respect to the starting weights, exact (second order through every
  inner step) and first order, 1 and 2 steps, on the quadratic of
  ``tests/test_maml.py`` and on LeNet (``lenet_loss``, 4 images), against
  ``jax.grad`` of the reference's;
* ``meta_step`` over 3 tasks, both modes, 1 and 2 inner steps, on the
  same two losses: the new weights and the loss at rtol 1e-5, atol 1e-6;
* ``adapt_new_member``; the reference's four ``tests/test_maml.py``
  cases on the port; exact against first order at a small and a large
  ``alpha``, in both packages alike;
* an initializer registered through ``cluster_init`` in both packages, a
  ``Strategy`` naming it, run through ``api.run`` at 8 clients and 2
  rounds on both sides from the same setup and draws, at the golden bar;
* ``examples/constellation_demo_torch.py --device cpu``, shortened
  through its own arguments.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import clustering as jcl
from repro.core import maml as jmaml
from repro.core import strategies as jstrat
from repro.models.lenet import lenet_loss as jlenet_loss

from repro_torch import api as tapi
from repro_torch.core import clustering as tcl
from repro_torch.core import engine as tengine
from repro_torch.core import maml as tmaml
from repro_torch.core import strategies as tstrat
from repro_torch.models.lenet import lenet_loss as tlenet_loss
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

from test_torch_jaxref import bridged

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-6          # float32, parameters and losses


# ---------------------------------------------------------------- inputs

def _jquad(params, batch):
    return jnp.sum(jnp.square(params["w"] - batch))


def _tquad(params, batch):
    return ((params["w"] - batch) ** 2).sum()


def _lenet_params(g):
    """LeNet's shapes (28 x 28 x 1 images, 10 classes), drawn with numpy
    at the reference's scales, biases nonzero."""
    shapes = {"c1": (5, 5, 1, 6), "c2": (5, 5, 6, 16), "f1": (256, 120),
              "f2": (120, 84), "f3": (84, 10)}
    return {name: {"w": (g.standard_normal(s) / np.sqrt(np.prod(s[:-1])))
                   .astype(np.float32),
                   "b": (0.1 * g.standard_normal(s[-1])).astype(np.float32)}
            for name, s in shapes.items()}


def _lenet_batch(g, lead=()):
    return (g.standard_normal(lead + (4, 28, 28, 1)).astype(np.float32),
            g.integers(0, 10, lead + (4,)).astype(np.int32))


def _case(loss, seed, tasks=None):
    """(params, support, query) as numpy, for ``loss`` in {"quad",
    "lenet"}; a leading task dimension of ``tasks`` on the batches."""
    g = np.random.default_rng(seed)
    lead = () if tasks is None else (tasks,)
    if loss == "quad":
        params = {"w": g.standard_normal(3).astype(np.float32)}
        return (params, g.standard_normal(lead + (3,)).astype(np.float32),
                g.standard_normal(lead + (3,)).astype(np.float32))
    return _lenet_params(g), _lenet_batch(g, lead), _lenet_batch(g, lead)


LOSSES = {"quad": (_jquad, _tquad), "lenet": (jlenet_loss, tlenet_loss)}
# alpha large enough that the second-order term shows: a first-order
# gradient misses the exact one by far more than the tolerance
ALPHA = {"quad": 0.2, "lenet": 0.1}


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(tree):
    return tree_map(lambda a: torch.as_tensor(np.asarray(a)), tree)


def _close(got, want, rtol=RTOL, atol=ATOL):
    """A port tree against a reference tree, leaf by leaf by key (JAX
    orders a dict's leaves by sorted key, the port by insertion)."""
    if isinstance(got, dict):
        assert set(got) == set(want)
        for key in got:
            _close(got[key], want[key], rtol, atol)
        return
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=rtol, atol=atol)


# ------------------------------------------------------------ inner_adapt

@pytest.mark.parametrize("steps", [1, 2])
@pytest.mark.parametrize("first_order", [False, True],
                         ids=["exact", "first-order"])
@pytest.mark.parametrize("loss", ["quad", "lenet"])
def test_inner_adapt_gradient_matches_reference(loss, first_order, steps):
    """d L_query(inner_adapt(p)) / d p: the port's autograd against
    ``jax.grad`` of the reference's.  A port whose ``inner_adapt``
    detaches its gradients gives the first-order gradient in exact mode
    (and has no ``first_order``): it fails here."""
    jl, tl = LOSSES[loss]
    alpha = ALPHA[loss]
    params, support, query = _case(loss, 11 + steps)

    def jouter(p):
        return jl(jmaml.inner_adapt(jl, p, _j(support), alpha, steps,
                                    first_order), _j(query))
    jval, jgrad = jax.value_and_grad(jouter)(_j(params))

    p = tree_map(lambda x: x.requires_grad_(True), _t(params))
    adapted = tmaml.inner_adapt(tl, p, _t(support), alpha, steps,
                                first_order=first_order)
    val = tl(adapted, _t(query))
    grad = torch.autograd.grad(val, tree_leaves(p))
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=RTOL)
    _close(tree_unflatten(p, list(grad)), jgrad)
    # the adapted weights themselves, and the detached route (no leaf
    # requires grad: the engine's calls) gives the same weights
    jadapted = jmaml.inner_adapt(jl, _j(params), _j(support), alpha, steps,
                                 first_order)
    _close(adapted, jadapted)
    plain = tmaml.inner_adapt(tl, _t(params), _t(support), alpha, steps,
                              first_order=first_order)
    assert not any(x.requires_grad for x in tree_leaves(plain))
    _close(plain, jadapted)


# -------------------------------------------------------------- meta_step

@pytest.mark.parametrize("inner_steps", [1, 2])
@pytest.mark.parametrize("first_order", [False, True],
                         ids=["exact", "first-order"])
@pytest.mark.parametrize("loss", ["quad", "lenet"])
def test_meta_step_matches_reference(loss, first_order, inner_steps):
    """Eq. 17 over 3 tasks: the new meta-weights and the mean
    post-adaptation query loss against the reference's vmapped step."""
    jl, tl = LOSSES[loss]
    params, support, query = _case(loss, 21 + inner_steps, tasks=3)
    kw = dict(alpha=ALPHA[loss], beta=0.05, inner_steps=inner_steps,
              first_order=first_order)
    jnew, jloss = jmaml.meta_step(jl, _j(params), _j(support), _j(query),
                                  **kw)
    new, got_loss = tmaml.meta_step(tl, _t(params), _t(support),
                                    _t(query), **kw)
    np.testing.assert_allclose(float(got_loss), float(jloss), rtol=RTOL,
                               atol=ATOL)
    _close(new, jnew)
    assert not any(x.requires_grad for x in tree_leaves(new))


@pytest.mark.parametrize("alpha,apart", [(1e-3, False), (0.25, True)],
                         ids=["small-alpha", "large-alpha"])
def test_exact_and_first_order_part_as_the_reference_does(alpha, apart):
    """Second order is really second order: exact and first-order MAML
    agree at a small ``alpha`` and part at a large one, in the port as in
    the reference (the reference's third ``test_maml.py`` case, and its
    converse)."""
    p = {"w": np.asarray([0.2, -0.3], np.float32)}
    tasks = np.asarray([[1.0, 0.0], [0.0, 1.0]], np.float32)
    got, want = {}, {}
    for fo in (False, True):
        want[fo], _ = jmaml.meta_step(_jquad, _j(p), _j(tasks), _j(tasks),
                                      alpha=alpha, beta=0.1, first_order=fo)
        got[fo], _ = tmaml.meta_step(_tquad, _t(p), _t(tasks), _t(tasks),
                                     alpha=alpha, beta=0.1, first_order=fo)
        _close(got[fo], want[fo])
    gap = np.abs(got[False]["w"].numpy() - got[True]["w"].numpy()).max()
    jgap = np.abs(np.asarray(want[False]["w"])
                  - np.asarray(want[True]["w"])).max()
    np.testing.assert_allclose(gap, jgap, rtol=1e-4, atol=1e-7)
    if apart:
        assert gap > 1e-2, gap
    else:
        assert gap < 1e-2, gap


@pytest.mark.parametrize("loss", ["quad", "lenet"])
def test_adapt_new_member_matches_reference(loss):
    jl, tl = LOSSES[loss]
    # seed 32: at seed 31 LeNet's first step leaves a conv2 pre-activation
    # 8.2e-8 from zero, a ReLU knife edge that the two packages' float32
    # sums put on either side (the second step's weights then part by
    # 9e-4, where every other element agrees to 1e-7)
    params, support, _ = _case(loss, 32)
    want = jmaml.adapt_new_member(jl, _j(params), _j(support), ALPHA[loss],
                                  steps=2)
    got = tmaml.adapt_new_member(tl, _t(params), _t(support), ALPHA[loss],
                                 steps=2)
    _close(got, want)
    assert float(tl(got, _t(support))) < float(tl(_t(params), _t(support)))


# ------------------------------------- the reference's test_maml.py cases

def test_inner_adapt_descends():
    p = {"w": torch.zeros(3)}
    target = torch.tensor([1.0, -1.0, 2.0])
    before = _tquad(p, target)
    p2 = tmaml.inner_adapt(_tquad, p, target, alpha=0.1, steps=3)
    assert float(_tquad(p2, target)) < float(before)


def test_meta_step_improves_post_adaptation_loss():
    """Tasks are quadratics with targets ~ N(mu, 0.1^2 I), drawn with
    numpy: 50 meta-steps move w toward mu, in both packages alike."""
    mu = np.asarray([2.0, -3.0], np.float32)
    g = np.random.default_rng(0)
    draws = [(mu + 0.1 * g.standard_normal((8, 2))).astype(np.float32)
             for _ in range(51)]

    def post_adapt_loss(p, ts):
        return float(np.mean([float(_tquad(tmaml.inner_adapt(
            _tquad, p, t, 0.1), t)) for t in _t(ts)]))

    p, jp = {"w": torch.zeros(2)}, {"w": jnp.zeros(2)}
    before = post_adapt_loss(p, draws[-1])
    for tasks in draws[:50]:
        p, _ = tmaml.meta_step(_tquad, p, _t(tasks), _t(tasks), alpha=0.1,
                               beta=0.05)
        jp, _ = jmaml.meta_step(_jquad, jp, _j(tasks), _j(tasks),
                                alpha=0.1, beta=0.05)
    after = post_adapt_loss(p, draws[-1])
    assert after < before * 0.2, (before, after)
    np.testing.assert_allclose(p["w"].numpy(), mu, atol=0.5)
    _close(p, jp, rtol=1e-4, atol=1e-5)


def test_first_order_close_to_exact_for_small_alpha():
    p = {"w": torch.tensor([0.5, 0.5])}
    tasks = torch.tensor([[1.0, 0.0], [0.0, 1.0]])
    p_exact, _ = tmaml.meta_step(_tquad, p, tasks, tasks, alpha=1e-3,
                                 beta=0.1, first_order=False)
    p_fo, _ = tmaml.meta_step(_tquad, p, tasks, tasks, alpha=1e-3,
                              beta=0.1, first_order=True)
    np.testing.assert_allclose(p_exact["w"].numpy(), p_fo["w"].numpy(),
                               atol=1e-2)


def test_adapt_new_member_moves_toward_local_data():
    cluster_model = {"w": torch.zeros(2)}
    local = torch.tensor([4.0, 4.0])
    adapted = tmaml.adapt_new_member(_tquad, cluster_model, local,
                                     alpha=0.1, steps=2)
    assert float(_tquad(adapted, local)) < float(_tquad(cluster_model,
                                                        local))


# ------------------------------------------------------------ cluster_init

BLOCKS = "contiguous_blocks"
BLOCKS_METHOD = "fedhc-blocks"
BLOCKS_CFG = dict(method=BLOCKS_METHOD, num_clients=8, num_clusters=2,
                  rounds=2, eval_every=1, samples_per_client=32,
                  eval_size=128, local_steps=1, batch_size=16)


@pytest.fixture
def blocks_registered():
    """A deterministic initializer (consecutive satellites in equal
    blocks, centroids at the blocks' mean positions) registered through
    each package's ``cluster_init``, and fedhc with it as a strategy of
    its own; both removed afterwards."""
    @jstrat.cluster_init(BLOCKS)
    def _jblocks(rng, positions, label_hists, k):
        n = positions.shape[0]
        a = (jnp.arange(n) * k // n).astype(jnp.int32)
        return a, jcl.update_centroids(positions, a, positions[:k])

    @tstrat.cluster_init(BLOCKS)
    def _tblocks(gen, positions, label_hists, k):
        n = positions.shape[0]
        a = (torch.arange(n, device=positions.device) * k // n).to(
            torch.int32)
        return a, tcl.update_centroids(positions, a, positions[:k])

    for lib in (jstrat, tstrat):
        lib.register(dataclasses.replace(lib.get("fedhc"),
                                         name=BLOCKS_METHOD,
                                         cluster_init=BLOCKS))
    yield
    for lib in (jstrat, tstrat):
        lib.CLUSTER_INITS.pop(BLOCKS)
        lib._REGISTRY.pop(BLOCKS_METHOD)


def test_cluster_init_decorator_registers_the_builtins():
    assert set(tstrat.CLUSTER_INITS) == set(jstrat.CLUSTER_INITS) == {
        "position", "label_hist", "random", "single"}
    assert tstrat.cluster_init("position")(
        tstrat.CLUSTER_INITS["position"]) is tstrat.CLUSTER_INITS["position"]


def test_registered_cluster_init_runs_through_api_run(blocks_registered,
                                                      monkeypatch):
    """The strategy naming the new initializer through ``api.run`` in
    both packages.  The port's run is handed the reference's data, model
    and draws (`test_torch_jaxref.bridged`), but its clustering comes
    from its own registered initializer, held against the reference's
    first; the two histories meet at the golden bar."""
    tcfg, state0, data, draws, jcfg = bridged(**BLOCKS_CFG)
    pos0 = tengine._constellation_for(tcfg.num_clients).positions(0.0)
    a, cen = tstrat.CLUSTER_INITS[BLOCKS](torch.Generator(), pos0, None, 2)
    np.testing.assert_array_equal(a.numpy(), state0.assignment.numpy())
    np.testing.assert_array_equal(a.numpy(), [0] * 4 + [1] * 4)
    np.testing.assert_allclose(cen.numpy(), state0.centroids.numpy(),
                               rtol=1e-6, atol=1e-3)
    ps = tcl.ps_select(pos0, cen, a, 2)
    np.testing.assert_array_equal(ps.numpy(), state0.ps_index.numpy())
    own = state0._replace(assignment=a, centroids=cen, ps_index=ps)
    monkeypatch.setattr(tengine, "setup", lambda *args, **kw: (own, data))
    monkeypatch.setattr(tengine, "TorchDraws", lambda *args: draws)

    want = japi.run(japi.Scenario.from_flat(jcfg))
    got = tapi.run(tapi.Scenario.from_flat(tcfg), device="cpu")
    assert got.scenario.canonical_json() == want.scenario.canonical_json()
    assert got.round.tolist() == want.round.tolist() == [1, 2]
    assert got.reclusters == want.reclusters
    np.testing.assert_allclose(got.time_s, want.time_s, rtol=1e-5)
    np.testing.assert_allclose(got.energy_j, want.energy_j, rtol=1e-5)
    np.testing.assert_allclose(got.loss, want.loss, rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(got.acc, want.acc, atol=5e-3)


# ------------------------------------------------------------------ demo

def test_constellation_demo_runs_on_the_cpu():
    res = subprocess.run(
        [sys.executable, "examples/constellation_demo_torch.py", "--device",
         "cpu", "--rounds", "2", "--plan-dt", "600"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH="src"))
    assert res.returncode == 0, res.stderr[-3000:]
    out = res.stdout
    assert "constellation: 64 sats" in out
    assert "contact plan: 11 samples" in out
    assert "matched work (32 client-rounds)" in out
    assert "async telemetry:" in out
