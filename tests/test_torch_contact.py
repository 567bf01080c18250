"""The port's ISL topology, contact plans and routed costs against the JAX
reference, on a 4 x 8 Walker constellation at 1300 km.

Bars: (min,+) closures and hop counts on the same weights are bit-equal
(``min`` and one f32 add per candidate round alike in both libraries); a
chunked (min,+) product is bit-equal to the unchunked one.  Geometry-built
routes and plans hold the time grid, the GS-visibility and the inf/finite
reachability patterns exactly and values at rtol 1e-5: link costs go
through Eq. 6's ``log``, where the two libraries round an ulp apart (ROADMAP
queue 3), so a route's f32 value may differ by a few 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.orbits import constellation as jcon
from repro.orbits import contact as jcontact
from repro.orbits import cost as jcost
from repro.orbits import links as jlinks
from repro.orbits import topology as jtopo

from repro_torch.orbits import constellation as tcon
from repro_torch.orbits import contact as tcontact
from repro_torch.orbits import cost as tcost
from repro_torch.orbits import links as tlinks
from repro_torch.orbits import topology as ttopo

from test_torch_jaxref import reference_plan_to_numpy

RTOL = 1e-5
JC, TC = jcon.Constellation(4, 8), tcon.Constellation(4, 8)
JLP, TLP = jlinks.LinkParams(), tlinks.LinkParams()
TIMES = (0.0, 777.5, 2500.0, 5123.25)
# (max_range_km, max_hops): every pair reachable, and a fragmented graph
LINKS = ((8000.0, 8), (5000.0, 3))


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _assert_routes(got, want, rtol=RTOL):
    """Same inf/finite pattern exactly; finite values at ``rtol``."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol)


def _pos(t):
    return (JC.positions(jnp.float32(t)),
            TC.positions(torch.tensor(t, dtype=torch.float32)))


def _layout():
    """A static cluster layout (K = 3) from a seed: assignment, PS ids."""
    assignment = np.random.default_rng(0).integers(0, 3, 32).astype(np.int32)
    ps_index = np.asarray([np.flatnonzero(assignment == k)[0]
                           for k in range(3)], np.int32)
    return assignment, ps_index


@pytest.fixture(scope="module")
def plans():
    """Reference and port plans: full f32 and bf16, sliced, factorized."""
    assignment, ps_index = _layout()
    ref, port = {}, {}
    for name, kw in (("full", {}), ("bf16", "bf16"),
                     ("sliced", {"cluster_slices": (assignment, ps_index)})):
        if kw == "bf16":
            ref[name] = jcontact.build_contact_plan(
                JC, JLP, storage_dtype=jnp.bfloat16)
            port[name] = tcontact.build_contact_plan(
                TC, TLP, storage_dtype=torch.bfloat16, device="cpu")
            continue
        ref[name] = jcontact.build_contact_plan(JC, JLP, **kw)
        port[name] = tcontact.build_contact_plan(TC, TLP, device="cpu", **{
            k: tuple(_t(x) for x in v) for k, v in kw.items()})
    ref["factorized"] = jcontact.build_factorized_plan(
        JC, JLP, cluster_slices=(jnp.asarray(assignment),
                                 jnp.asarray(ps_index)))
    port["factorized"] = tcontact.build_factorized_plan(
        TC, TLP, cluster_slices=(_t(assignment), _t(ps_index)), device="cpu")
    return ref, port


# ---- link model and visibility --------------------------------------------


def test_time_per_bit_and_visibility_match_reference():
    d = np.linspace(500.0, 9000.0, 257).astype(np.float32)
    for to_ground in (False, True):
        np.testing.assert_allclose(
            tlinks.time_per_bit(_t(d), TLP, to_ground).numpy(),
            np.asarray(jlinks.time_per_bit(jnp.asarray(d), JLP, to_ground)),
            rtol=RTOL)
    for t in TIMES:
        jp, tp = _pos(t)
        jgs = jcon.ground_station_position(t_s=jnp.float32(t))
        tgs = tcon.ground_station_position(
            t_s=torch.tensor(t, dtype=torch.float32))
        np.testing.assert_allclose(tcon.elevation_deg(tp, tgs).numpy(),
                                   np.asarray(jcon.elevation_deg(jp, jgs)),
                                   atol=1e-4)
        for mask in (-90.0, 10.0, 30.0):
            np.testing.assert_array_equal(
                tcon.visible(tp, tgs, mask).numpy(),
                np.asarray(jcon.visible(jp, jgs, mask)))
        np.testing.assert_allclose(
            tcon.inter_sat_distance_km(tp, tp.roll(1, 0)).numpy(),
            np.asarray(jcon.inter_sat_distance_km(jp, jnp.roll(jp, 1, 0))),
            rtol=1e-6)


# ---- topology --------------------------------------------------------------


def test_line_of_sight_and_adjacency_match_reference():
    for t in TIMES:
        jp, tp = _pos(t)
        np.testing.assert_allclose(ttopo.pairwise_dist_km(tp).numpy(),
                                   np.asarray(jtopo.pairwise_dist_km(jp)),
                                   rtol=1e-6, atol=1e-2)
        np.testing.assert_allclose(
            ttopo.segment_min_dist_to_origin(tp).numpy(),
            np.asarray(jtopo.segment_min_dist_to_origin(jp)), rtol=1e-6,
            atol=1e-2)
        np.testing.assert_array_equal(ttopo.line_of_sight(tp).numpy(),
                                      np.asarray(jtopo.line_of_sight(jp)))
        for max_range, _ in LINKS:
            adj = ttopo.isl_adjacency(tp, max_range).numpy()
            np.testing.assert_array_equal(
                adj, np.asarray(jtopo.isl_adjacency(jp, max_range)))
            assert not adj.diagonal().any() and (adj == adj.T).all()


def _weights(n, seed, p_edge=0.3):
    """A reflexive one-hop weight matrix with inf where no edge."""
    g = np.random.default_rng(seed)
    w = g.uniform(0.1, 2.0, (n, n)).astype(np.float32)
    w = np.where(g.random((n, n)) < p_edge, w, np.inf).astype(np.float32)
    np.fill_diagonal(w, 0.0)
    return w


@pytest.mark.parametrize("max_hops", [1, 2, 3, 5, 8])
def test_min_plus_closure_and_hops_are_bit_equal(max_hops):
    w = _weights(40, max_hops)
    np.testing.assert_array_equal(
        ttopo.min_plus_closure(_t(w), max_hops).numpy(),
        np.asarray(jtopo.min_plus_closure(jnp.asarray(w), max_hops)))
    adj = np.isfinite(w) & ~np.eye(40, dtype=bool)
    np.testing.assert_array_equal(
        ttopo.hop_counts(_t(adj), max_hops).numpy(),
        np.asarray(jtopo.hop_counts(jnp.asarray(adj), max_hops)))
    src = np.asarray([0, 7, 39], np.int32)
    np.testing.assert_array_equal(
        ttopo.hop_rows(_t(adj), _t(src), max_hops).numpy(),
        np.asarray(jtopo.hop_rows(jnp.asarray(adj), jnp.asarray(src),
                                  max_hops)))


def test_chunked_min_plus_product_is_bit_identical():
    """Row chunks under a byte budget give the unchunked product bit for
    bit, ragged last chunk included, and so does the closure."""
    a, b = _t(_weights(37, 1, 0.5)), _t(_weights(37, 2, 0.5))
    whole = ttopo._min_plus_mul(a, b, chunk_bytes=1 << 30)
    row = 37 * 37 * 4
    for rows in (1, 2, 5, 36):
        assert torch.equal(ttopo._min_plus_mul(a, b, chunk_bytes=rows * row),
                           whole)
    w = _t(_weights(37, 3))
    assert torch.equal(ttopo.min_plus_closure(w, 8, chunk_bytes=3 * row),
                       ttopo.min_plus_closure(w, 8, chunk_bytes=1 << 30))


@pytest.mark.parametrize("max_range,max_hops", LINKS)
def test_routes_match_reference(max_range, max_hops):
    src = np.asarray([0, 13, 31], np.int32)
    for t in TIMES:
        jp, tp = _pos(t)
        full = ttopo.route_time_per_bit(tp, TLP, max_range, max_hops)
        _assert_routes(full, jtopo.route_time_per_bit(jp, JLP, max_range,
                                                      max_hops))
        want = jtopo.route_rows_time_per_bit(jp, jnp.asarray(src), JLP,
                                             max_range, max_hops)
        for col_block in (0, 5):              # one block, and padded blocks
            rows = ttopo.route_rows_time_per_bit(
                tp, _t(src), TLP, max_range, max_hops, col_block=col_block)
            _assert_routes(rows, want)
            _assert_routes(rows, full[src.astype(np.int64)])


# ---- contact plans ---------------------------------------------------------


@pytest.mark.parametrize("name", ["full", "bf16", "sliced"])
def test_stored_plans_match_reference(plans, name):
    ref, port = plans
    r, p = ref[name], port[name]
    assert type(p).__name__ == type(r).__name__
    np.testing.assert_array_equal(p.times.numpy(), np.asarray(r.times))
    np.testing.assert_array_equal(p.gs_visible.numpy(),
                                  np.asarray(r.gs_visible))
    np.testing.assert_allclose(p.gs_dist_km.numpy(), np.asarray(r.gs_dist_km),
                               rtol=RTOL)
    tables = ("tpb_to_ps", "ps_rows") if name == "sliced" else ("isl_tpb",)
    for field in tables:
        got, want = getattr(p, field), getattr(r, field)
        assert str(got.dtype)[6:] == str(want.dtype)
        _assert_routes(got.float(), want)
    if name == "sliced":
        # the slices are the full table's gathers, bit for bit
        assignment, ps_index = _layout()
        full = port["full"].isl_tpb
        members = torch.arange(32)
        ps = _t(ps_index).long()
        assert torch.equal(p.tpb_to_ps, full[:, members,
                                             ps[_t(assignment).long()]])
        assert torch.equal(p.ps_rows, full[:, ps])
    if name == "bf16":
        # bf16 storage is the f32 table rounded, inf kept
        assert torch.equal(p.isl_tpb, port["full"].isl_tpb.bfloat16())


def test_factorized_plan_matches_reference(plans):
    ref, port = plans
    r, p = ref["factorized"], port["factorized"]
    np.testing.assert_array_equal(p.times.numpy(), np.asarray(r.times))
    sliced = port["sliced"]
    for t in (0.0, 60.3, 1234.5, 6000.0, 9999.0):   # 9999 s wraps
        got = tcontact.lookup_sliced(p, torch.tensor(t, dtype=torch.float32))
        want = jcontact.lookup_sliced(r, jnp.float32(t))
        stored = tcontact.lookup_sliced(sliced,
                                        torch.tensor(t, dtype=torch.float32))
        for g, w, s in zip(got, want, stored):
            if g.dtype == torch.bool:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
                assert torch.equal(g, s)
            else:
                _assert_routes(g, w)
                _assert_routes(g, s)


def test_sample_index_and_lookup_wrap_like_the_reference(plans):
    ref, port = plans
    p, r = port["full"], ref["full"]
    n = p.times.shape[0]
    dt = float(p.times[1] - p.times[0])
    # nearest samples, half-sample ties (round half to even), the wrap
    ts = np.asarray([0.0, 0.3 * dt, 0.5 * dt, 1.5 * dt, 2.5 * dt, 7.49 * dt,
                     (n - 0.5) * dt, n * dt, 3 * n * dt + 4 * dt, 1e5],
                    np.float32)
    np.testing.assert_array_equal(
        tcontact._sample_index(p, torch.from_numpy(ts)).numpy(),
        np.asarray(jcontact._sample_index(r, jnp.asarray(ts))))
    for t in ts:
        vis, dist, tpb = tcontact.lookup(p, torch.tensor(t))
        idx = int(tcontact._sample_index(p, torch.tensor(t)))
        assert torch.equal(vis, p.gs_visible[idx])
        assert torch.equal(dist, p.gs_dist_km[idx])
        assert torch.equal(tpb, p.isl_tpb[idx])
    assert torch.equal(tcontact.lookup(p, float(n * dt))[2], p.isl_tpb[0])
    # bf16 storage: upcast to f32 at lookup
    tpb16 = tcontact.lookup(port["bf16"], 600.0)[2]
    assert tpb16.dtype == torch.float32


def test_contact_windows_match_reference(plans):
    ref, port = plans
    for sat in range(32):
        assert (tcontact.contact_windows(port["full"], sat)
                == jcontact.contact_windows(ref["full"], sat))


def test_route_to_ps_per_client_matches_reference(plans):
    ref, port = plans
    assignment, ps_index = _layout()
    t_clients = np.linspace(0.0, 9000.0, 32).astype(np.float32)
    ps_of_member = ps_index[assignment]
    for name in ("full", "sliced"):
        got = tcontact.route_to_ps_per_client(
            port[name], _t(t_clients), _t(ps_of_member))
        want = jcontact.route_to_ps_per_client(
            ref[name], jnp.asarray(t_clients), jnp.asarray(ps_of_member))
        _assert_routes(got, want)
    with pytest.raises(NotImplementedError, match="FactorizedContactPlan"):
        tcontact.route_to_ps_per_client(port["factorized"], _t(t_clients),
                                        _t(ps_of_member))
    with pytest.raises(ValueError, match="cluster_slices"):
        tcontact.build_factorized_plan(TC, device="cpu")


def test_plan_numpy_round_trip(plans):
    ref, port = plans
    for name, plan in port.items():
        back = tcontact.plan_from_numpy(tcontact.plan_to_numpy(plan),
                                        device="cpu")
        assert type(back) is type(plan)
        if name == "factorized":
            assert back.constellation == plan.constellation
            assert back.link_params == plan.link_params
            assert back.col_block == plan.col_block
            tensors = ("times", "assignment", "ps_index")
        else:
            tensors = plan._fields
        for field in tensors:
            want = getattr(plan, field)
            got = getattr(back, field)
            assert torch.equal(got, want.float() if want.dtype
                               == torch.bfloat16 else want), (name, field)
        # a reference plan carried in gives the reference's arrays back
        carried = tcontact.plan_from_numpy(
            reference_plan_to_numpy(ref[name]), device="cpu")
        assert type(carried) is type(plan)
        out = tcontact.plan_to_numpy(carried)
        for field, want in reference_plan_to_numpy(ref[name]).items():
            if isinstance(want, np.ndarray):
                np.testing.assert_array_equal(
                    out[field], np.asarray(want, out[field].dtype))
    assert carried.constellation == TC        # the factorized one


# ---- routed costs ----------------------------------------------------------


def test_routed_costs_match_reference():
    """The four routed cost functions on the same inputs, unreachable
    routes (inf) included: finite results at 1e-5."""
    g = np.random.default_rng(5)
    n, k, bits = 24, 4, 431_080.0
    tpb = g.uniform(1e-7, 4e-6, n).astype(np.float32)
    tpb[[3, 11]] = np.inf
    reach = np.isfinite(tpb)
    sizes = np.full(n, 64.0, np.float32)
    freqs = g.uniform(1e8, 1e9, n).astype(np.float32)
    jcp, tcp = jcost.ComputeParams(), tcost.ComputeParams()
    pairs = [
        (tcost.routed_cluster_member_costs(_t(tpb), _t(reach), _t(sizes),
                                           _t(freqs), bits, TLP, tcp),
         jcost.routed_cluster_member_costs(tpb, reach, sizes, freqs, bits,
                                           JLP, jcp)),
        (tcost.routed_cluster_round_costs(_t(tpb), _t(reach), _t(sizes),
                                          _t(freqs), bits, TLP, tcp),
         jcost.routed_cluster_round_costs(tpb, reach, sizes, freqs, bits,
                                          JLP, jcp)),
    ]
    to_gw = g.uniform(0.0, 3e-6, k).astype(np.float32)
    pairs.append((tcost.routed_ground_round_costs(
        _t(to_gw), torch.tensor(2345.6), bits, TLP),
        jcost.routed_ground_round_costs(to_gw, jnp.float32(2345.6), bits,
                                        JLP)))
    ps_pairs = g.uniform(1e-7, 3e-6, (k, k)).astype(np.float32)
    np.fill_diagonal(ps_pairs, 0.0)
    pairs.append((tcost.isl_consensus_costs(_t(ps_pairs), bits, TLP),
                  jcost.isl_consensus_costs(ps_pairs, bits, JLP)))
    for got, want in pairs:
        for a, b in zip(got, want):
            assert torch.isfinite(a).all()
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL)
