"""The port's modules against their JAX counterparts, on the CPU, from the
same inputs (numpy from a seed, or drawn by the reference and handed over).

Tolerances: LeNet logits, losses and gradients rtol 1e-5; positions and
compute costs rtol 1e-6, link costs 1e-5 (see the cost test); gathers and
k-means assignments exact;
aggregation and the MAML meta-update rtol 1e-5.  Both sides compute in
float32, so what differs is summation order inside reductions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core import clustering as jcl
from repro.core import fedhc as jfedhc
from repro.core import maml as jmaml
from repro.models import lenet as jlenet
from repro.orbits import constellation as jcon
from repro.orbits import cost as jcost
from repro.orbits.links import LinkParams as JLinkParams

from repro_torch.core import aggregation as tagg
from repro_torch.core import clustering as tcl
from repro_torch.core import fedhc as tfedhc
from repro_torch.core import maml as tmaml
from repro_torch.core import strategies as tstrat
from repro_torch.core.engine import _constellation_for
from repro_torch.data import synthetic as tsyn
from repro_torch.models import lenet as tlenet
from repro_torch.orbits import constellation as tcon
from repro_torch.orbits import cost as tcost
from repro_torch.orbits.links import LinkParams as TLinkParams
from repro_torch.tree import tree_leaves

from test_torch_jaxref import reference_setup

CPU = torch.device("cpu")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a)).to(dtype)


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _batch(seed, lead=(), b=6, img=28):
    g = np.random.default_rng(seed)
    x = g.standard_normal(lead + (b, img, img, 1)).astype(np.float32)
    y = g.integers(0, 10, lead + (b,)).astype(np.int32)
    return x, y


def _stack_params(c):
    """C different LeNet models: the JAX params and the port's tensors."""
    ws = [jlenet.init_lenet(jax.random.PRNGKey(i)) for i in range(c)]
    jstack = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *ws)
    return jstack, tlenet.from_numpy(_np(jstack), CPU)


# ------------------------------------------------------------------ LeNet

def test_lenet_forward_loss_grads_match_carried_weights():
    w = jlenet.init_lenet(jax.random.PRNGKey(3))
    x, y = _batch(0)
    tw = tlenet.from_numpy(_np(w), CPU)
    _close(tlenet.lenet_forward(tw, _t(x)).numpy(),
           jax.jit(jlenet.lenet_forward)(w, jnp.asarray(x)), rtol=1e-5,
           atol=1e-6)
    jl, jg = jax.jit(jax.value_and_grad(jlenet.lenet_loss))(
        w, (jnp.asarray(x), jnp.asarray(y)))
    tl, tg = tmaml.grad_tree(tlenet.lenet_loss, tw, (_t(x), _t(y, torch.long)))
    _close(tl.detach().numpy(), jl, rtol=1e-5)
    for a, b in zip(tree_leaves(tg), jax.tree_util.tree_leaves(jg)):
        _close(a.numpy(), b, rtol=1e-5, atol=1e-6)
    _close(tlenet.lenet_accuracy(tw, _t(x), _t(y, torch.long)).numpy(),
           jax.jit(jlenet.lenet_accuracy)(w, jnp.asarray(x),
                                          jnp.asarray(y)),
           rtol=0)


def test_lenet_client_dimension_is_the_reference_vmap():
    """(C, ...) params with (C, B, ...) batches == vmap over clients; the
    gradient of the summed per-client losses is each client's gradient."""
    jstack, tstack = _stack_params(3)
    x, y = _batch(1, lead=(3,))
    batch = (jnp.asarray(x), jnp.asarray(y))
    jl, jg = jax.jit(jax.vmap(jax.value_and_grad(jlenet.lenet_loss)))(
        jstack, batch)
    tl, tg = tmaml.grad_tree(tlenet.lenet_loss, tstack,
                             (_t(x), _t(y, torch.long)))
    assert tl.shape == (3,)
    _close(tl.detach().numpy(), jl, rtol=1e-5)
    for a, b in zip(tree_leaves(tg), jax.tree_util.tree_leaves(jg)):
        _close(a.numpy(), b, rtol=1e-5, atol=1e-6)


def test_local_train_matches_reference_and_microbatch():
    jstack, tstack = _stack_params(4)
    x, y = _batch(2, lead=(4,))
    jp, jl = jax.jit(jfedhc._local_train, static_argnames=("lr", "steps"))(
        jstack, jnp.asarray(x), jnp.asarray(y), lr=0.05, steps=2)
    for mb in (0, 3):
        tp, tl = tfedhc._local_train(tstack, _t(x), _t(y, torch.long),
                                     lr=0.05, steps=2, microbatch=mb)
        _close(tl.numpy(), jl, rtol=1e-5)
        for a, b in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
            _close(a.numpy(), b, rtol=1e-5, atol=1e-6)


def test_meta_update_matches_jax():
    """Eq. 16-17: the members' gradients at their adapted weights, summed
    per cluster.  alpha = 0.5 makes the inner step matter, and beta = 1
    exposes the summed meta-gradient itself."""
    k, c = 2, 4
    jstack, _ = _stack_params(k)
    assignment = np.array([0, 1, 1, 0], np.int32)
    x, y = _batch(4, lead=(c,))
    meta = jax.jit(jfedhc._meta_update_clusters,
                   static_argnames=("k", "alpha", "beta"))
    want = meta(jstack, jnp.asarray(assignment), jnp.asarray(x),
                jnp.asarray(y), k=k, alpha=0.5, beta=1.0)
    got = tfedhc._meta_update_clusters(
        tlenet.from_numpy(_np(jstack), CPU), _t(assignment, torch.int32),
        _t(x), _t(y, torch.long), k=k, alpha=0.5, beta=1.0)
    for a, b, w0 in zip(tree_leaves(got), jax.tree_util.tree_leaves(want),
                        jax.tree_util.tree_leaves(jstack)):
        # compare the meta-gradient (w0 - w1), not the tiny-step weights
        _close((np.asarray(w0) - a.numpy()), np.asarray(w0) - np.asarray(b),
               rtol=1e-4, atol=1e-6)
    first_order = meta(jstack, jnp.asarray(assignment), jnp.asarray(x),
                       jnp.asarray(y), k=k, alpha=0.0, beta=1.0)
    gap = max(float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
              for a, b in zip(jax.tree_util.tree_leaves(want),
                              jax.tree_util.tree_leaves(first_order)))
    assert gap > 1e-3        # the inner step really moves the gradient


def test_inner_adapt_matches_reference():
    w = jlenet.init_lenet(jax.random.PRNGKey(5))
    x, y = _batch(5)
    want = jax.jit(lambda w, b: jmaml.inner_adapt(jlenet.lenet_loss, w, b,
                                                  0.1, steps=2))(
        w, (jnp.asarray(x), jnp.asarray(y)))
    got = tmaml.inner_adapt(tlenet.lenet_loss, tlenet.from_numpy(_np(w), CPU),
                            (_t(x), _t(y, torch.long)), 0.1, steps=2)
    for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        _close(a.numpy(), b, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------- data

def test_smooth_is_jax_bilinear_resize():
    coarse = np.random.default_rng(6).standard_normal(
        (5, 7, 7, 3)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(coarse), (5, 28, 28, 3),
                            method="bilinear")
    _close(tsyn.smooth_from_coarse(_t(coarse), 28).numpy(), want, rtol=0,
           atol=1e-6)


def test_client_batches_gather_the_same_examples():
    g = np.random.default_rng(7)
    images = g.standard_normal((40, 28, 28, 1)).astype(np.float32)
    labels = g.integers(0, 10, 40)
    client_idx = g.integers(0, 40, (5, 8))
    picks = g.integers(0, 8, (5, 3))
    ti, tl = tsyn.client_batches(_t(images), _t(labels, torch.long),
                                 _t(client_idx, torch.long),
                                 _t(picks, torch.long))
    flat = np.take_along_axis(client_idx, picks, axis=1)
    np.testing.assert_array_equal(ti.numpy(), images[flat])
    np.testing.assert_array_equal(tl.numpy(), labels[flat])


def test_native_data_has_the_reference_shapes_and_partition():
    gen = torch.Generator().manual_seed(0)
    (x, y), (tx, ty) = tsyn.make_split(gen, tsyn.MNIST_LIKE, 300, 50)
    assert x.shape == (300, 28, 28, 1) and tx.shape == (50, 28, 28, 1)
    assert x.dtype == torch.float32 and set(y.unique().tolist()) <= set(
        range(10))
    idx = tsyn.dirichlet_partition(gen, y, 6, 0.5, 20, 10)
    assert idx.shape == (6, 20) and int(idx.min()) >= 0
    assert int(idx.max()) < 300
    g = tsyn._gamma(torch.Generator().manual_seed(1), 0.5, (20000,))
    assert abs(float(g.mean()) - 0.5) < 0.03       # Gamma(a, 1) mean = a
    assert abs(float(g.var()) - 0.5) < 0.06        # and variance = a


# ----------------------------------------------------------------- orbits

@pytest.mark.parametrize("n", [16, 32, 800])
def test_positions_match(n):
    con = _constellation_for(n)
    jc = jcon.Constellation(con.num_planes, con.sats_per_plane)
    for t in (0.0, 61.5, 3600.0):
        _close(con.positions(torch.tensor(t)).numpy(),
               jc.positions(jnp.float32(t)), rtol=1e-6, atol=1e-2)
    _close(con.positions(0.0).numpy(), jc.positions(0.0), rtol=1e-6,
           atol=1e-2)
    _close(tcon.ground_station_position(t_s=torch.tensor(300.0)).numpy(),
           jcon.ground_station_position(t_s=jnp.float32(300.0)), rtol=1e-6)


def test_cost_functions_match():
    """Every always-up cost function on the engine's own geometry: a
    32-satellite constellation 300 s in, its k-means clusters and PSs, the
    ground station at that time.  Pure arithmetic (compute time and
    energy) agrees to 1e-6.  The link terms go through Eq. 6's
    log(1 + x) with x ~ 0.05 at intra-cluster distances: XLA's and torch's
    log, and XLA's rewrite of the division by N0, differ by an ulp in
    about a fifth of the cases, and 1/log(1 + x) ~ 20 amplifies that to a
    few 1e-6, so those are held at the engine's time/energy bar, 1e-5."""
    g = np.random.default_rng(8)
    c, k = 32, 4
    pos = np.asarray(_constellation_for(c).positions(torch.tensor(300.0)))
    res = tcl.kmeans(_t(pos), k, torch.arange(k))
    assignment = res.assignment.numpy()
    ps = res.ps_index.numpy()
    ps_pos = pos[ps][assignment]
    gs = tcon.ground_station_position(t_s=torch.tensor(300.0)).numpy()
    sizes = np.full(c, 64.0, np.float32)
    freqs = g.uniform(1e8, 1e9, c).astype(np.float32)
    part = np.ones(c, bool)
    jlp, tlp = JLinkParams(), TLinkParams()
    jcp, tcp = jcost.ComputeParams(), tcost.ComputeParams()
    bits = 44426 * 32.0
    pairs = [
        (tcost.compute_time_s(_t(sizes), _t(freqs), tcp),
         jcost.compute_time_s(jnp.asarray(sizes), jnp.asarray(freqs), jcp)),
        (tcost.compute_energy_j(_t(sizes), _t(freqs), tcp),
         jcost.compute_energy_j(jnp.asarray(sizes), jnp.asarray(freqs), jcp)),
    ]
    pairs += list(zip(
        tcost.cluster_member_costs(_t(pos), _t(ps_pos), _t(sizes), _t(freqs),
                                   bits, tlp, tcp),
        jcost.cluster_member_costs(jnp.asarray(pos), jnp.asarray(ps_pos),
                                   jnp.asarray(sizes), jnp.asarray(freqs),
                                   bits, jlp, jcp)))
    pairs += list(zip(
        tcost.cluster_round_costs(_t(pos), _t(ps_pos),
                                  _t(assignment, torch.int32),
                                  _t(part, torch.bool), _t(sizes), _t(freqs),
                                  bits, tlp, tcp),
        jcost.cluster_round_costs(jnp.asarray(pos), jnp.asarray(ps_pos),
                                  jnp.asarray(assignment), jnp.asarray(part),
                                  jnp.asarray(sizes), jnp.asarray(freqs),
                                  bits, jlp, jcp)))
    pairs += list(zip(
        tcost.ground_round_costs(_t(pos[ps]), _t(gs), bits, tlp),
        jcost.ground_round_costs(jnp.asarray(pos[ps]), jnp.asarray(gs), bits,
                                 jlp)))
    pairs += list(zip(
        tcost.cfedavg_round_costs(_t(pos), _t(pos[ps[0]]),
                                  _t(part, torch.bool), _t(sizes), _t(freqs),
                                  28 * 28 * 32.0, 1e9, tlp, tcp),
        jcost.cfedavg_round_costs(jnp.asarray(pos), jnp.asarray(pos[ps[0]]),
                                  jnp.asarray(part), jnp.asarray(sizes),
                                  jnp.asarray(freqs), 28 * 28 * 32.0, 1e9,
                                  jlp, jcp)))
    for i, (got, want) in enumerate(pairs):
        _close(got.numpy(), want, rtol=1e-6 if i < 2 else 1e-5)


# ------------------------------------------------------------- clustering

@pytest.mark.parametrize("n,k,t", [(16, 3, 0.0), (64, 4, 900.0),
                                   (800, 4, 240.0)])
def test_kmeans_from_the_same_init_indices(n, k, t):
    con = _constellation_for(n)
    jpos = jcon.Constellation(con.num_planes,
                              con.sats_per_plane).positions(jnp.float32(t))
    rng = jax.random.PRNGKey(n + k)
    init_idx = np.asarray(jax.random.choice(rng, n, (k,), replace=False))
    want = jcl.kmeans(jpos, k, rng)
    got = tcl.kmeans(_t(jpos), k, _t(init_idx, torch.long))
    np.testing.assert_array_equal(got.assignment.numpy(), want.assignment)
    np.testing.assert_array_equal(got.ps_index.numpy(), want.ps_index)
    assert int(got.iterations) == int(want.iterations)
    _close(got.centroids.numpy(), want.centroids, rtol=1e-5, atol=1e-2)


@pytest.mark.parametrize("method", ["fedhc", "fedce", "h-base"])
def test_initial_clustering_from_reference_setup(method):
    """The port re-derives the reference's t=0 clustering and PS picks from
    its own positions (the symmetric t=0 geometry is where argmin ties
    would show): assignment and PS exact, centroids to float rounding."""
    from repro.core.fedhc import FLRunConfig
    cfg = FLRunConfig(method=method, num_clients=16, num_clusters=3,
                      samples_per_client=32, eval_size=64)
    arrays, _, data = reference_setup(cfg)
    pos0 = _constellation_for(16).positions(0.0)
    kinit = np.asarray(jax.random.choice(data.r_kmeans, 16, (3,),
                                         replace=False))
    if method == "fedhc":
        res = tcl.kmeans(pos0, 3, _t(kinit, torch.long))
        assignment, centroids = res.assignment, res.centroids
    elif method == "fedce":
        hists = torch.nn.functional.one_hot(
            _t(arrays["labels"], torch.long)[_t(arrays["client_idx"],
                                                torch.long)], 10).sum(1)
        res = tcl.kmeans((hists / 32).float(), 3, _t(kinit, torch.long))
        assignment = res.assignment
        centroids = tcl.update_centroids(pos0, assignment,
                                         pos0[res.ps_index.long()])
    else:   # h-base: the reference's random assignment, handed over
        assignment = _t(arrays["assignment0"], torch.int32)
        centroids = tcl.update_centroids(pos0, assignment, pos0[:3])
    np.testing.assert_array_equal(assignment.numpy(), arrays["assignment0"])
    _close(centroids.numpy(), arrays["centroids0"], rtol=1e-5, atol=1e-2)
    # PS picks: exact, except where two members are equidistant from the
    # centroid up to rounding (the t=0 geometry is symmetric, and fedhc's
    # seed-0 clusters hold such a tie); the bridged engine runs take the
    # reference's picks
    ps = tcl.ps_select(pos0, centroids, assignment, 3).numpy()
    want = arrays["ps_index0"]
    d = tcl.pairwise_sq_dist(pos0, centroids).numpy()
    for kk in range(3):
        assert assignment[ps[kk]] == assignment[want[kk]] == kk
        _close(d[ps[kk], kk], d[want[kk], kk], rtol=1e-6)


def test_cluster_inits_registry_matches_reference():
    from repro.core import strategies as jstrat
    assert set(tstrat.CLUSTER_INITS) == set(jstrat.CLUSTER_INITS)
    gen = torch.Generator().manual_seed(0)
    pos = _constellation_for(16).positions(0.0)
    hists = torch.rand((16, 10), generator=gen)
    for name, fn in tstrat.CLUSTER_INITS.items():
        k = 1 if name == "single" else 3
        a, c = fn(gen, pos, hists, k)
        assert a.shape == (16,) and a.dtype == torch.int32
        assert c.shape == (k, 3) and int(a.max()) < k


def test_dropout_rate_matches():
    g = np.random.default_rng(9)
    part = g.uniform(size=20) > 0.4
    a = g.integers(0, 4, 20).astype(np.int32)
    _close(tcl.dropout_rate(_t(part, torch.bool), _t(a, torch.int32),
                            4).numpy(),
           jcl.dropout_rate(jnp.asarray(part), jnp.asarray(a), 4), rtol=1e-6)


# ------------------------------------------------------------ aggregation

def _agg_inputs(seed, c=12, k=3):
    g = np.random.default_rng(seed)
    stack = {"w": g.standard_normal((c, 5, 4)).astype(np.float32),
             "b": g.standard_normal((c, 7)).astype(np.float32)}
    losses = g.uniform(0.5, 2.5, c).astype(np.float32)
    sizes = g.integers(16, 64, c).astype(np.float32)
    assignment = g.integers(0, k, c).astype(np.int32)
    part = g.uniform(size=c) > 0.2
    return stack, losses, sizes, assignment, part


@pytest.mark.parametrize("use_kernels", [False, True])
def test_cluster_aggregate_matches(use_kernels):
    stack, losses, _, assignment, _ = _agg_inputs(10)
    w = np.random.default_rng(11).uniform(size=12).astype(np.float32)
    want = jagg.cluster_aggregate(stack, jnp.asarray(w),
                                  jnp.asarray(assignment), 3)
    got = tagg.cluster_aggregate({k: _t(v) for k, v in stack.items()},
                                 _t(w), _t(assignment, torch.int32), 3,
                                 use_kernels=use_kernels)
    for key in stack:
        _close(got[key].numpy(), want[key], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("do_global", [False, True])
@pytest.mark.parametrize("loss_weighted", [False, True])
def test_hierarchical_round_matches(do_global, loss_weighted):
    stack, losses, sizes, assignment, part = _agg_inputs(12)
    want = jagg.hierarchical_round(
        stack, jnp.asarray(losses), jnp.asarray(sizes),
        jnp.asarray(assignment), 3, jnp.asarray(part), do_global=do_global,
        loss_weighted=loss_weighted)
    for use_kernels in (False, True):
        got = tagg.hierarchical_round(
            {k: _t(v) for k, v in stack.items()}, _t(losses), _t(sizes),
            _t(assignment, torch.int32), 3, _t(part, torch.bool),
            do_global=do_global, loss_weighted=loss_weighted,
            use_kernels=use_kernels)
        for key in stack:
            _close(got[key].numpy(), want[key], rtol=1e-5, atol=1e-6)
