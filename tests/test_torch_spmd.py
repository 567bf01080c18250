"""The port's SPMD aggregation (``core/aggregation_spmd.py``) in four gloo
ranks on the CPU, against the JAX reference's pytree oracle
(``repro.core.aggregation``) and the port's own, on the same numpy
inputs (the cases of ``tests/test_aggregation_spmd.py``):

* ``make_spmd_aggregator`` (static groups, C = 8, K = 2) and the merged
  ``hierarchical_round_sharded`` on two cluster layouts (C = 16, K = 3),
  both stage-2 branches, creating no process group between layouts and
  launching the stage-1 route once a stage-1 on each rank;
* ``hierarchical_agg_shard``, one client a rank, on cluster sub-groups
  made once;
* ``buffered_flush_sharded`` against ``aggregation.buffered_flush``;
* the gathers are exact: rows, PS rows, the row mean.

All within 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg

from repro_torch.core import aggregation as tagg

from torch_ranks import run_ranks

TOL = 1e-6
W = 4


def _inputs(c, seed=0):
    g = np.random.default_rng(seed)
    stack = {"a": g.standard_normal((c, 4, 3)).astype(np.float32),
             "b": g.standard_normal((c, 5)).astype(np.float32)}
    losses = g.uniform(0.2, 3.0, c).astype(np.float32)
    sizes = g.integers(1, 9, c).astype(np.float32)
    return stack, losses, sizes


def _jax_round(stack, losses, sizes, assignment, k, do_global):
    out = jagg.hierarchical_round(
        {n: jnp.asarray(v) for n, v in stack.items()}, jnp.asarray(losses),
        jnp.asarray(sizes), jnp.asarray(assignment, jnp.int32), k,
        do_global=do_global)
    return {n: np.asarray(v) for n, v in out.items()}


def _torch_round(stack, losses, sizes, assignment, k, do_global):
    out = tagg.hierarchical_round(
        {n: torch.as_tensor(v) for n, v in stack.items()},
        torch.as_tensor(losses), torch.as_tensor(sizes),
        torch.as_tensor(np.asarray(assignment, np.int32)), k,
        do_global=do_global)
    return {n: v.numpy() for n, v in out.items()}


BODY = """
from repro_torch.core import aggregation as agg
from repro_torch.core import aggregation_spmd as spmd
from repro_torch.kernels import ops
from test_torch_spmd import _inputs, LAYOUTS, AGG_CLUSTERS

def rows_of(tree, shard):
    return {n: shard.local(torch.as_tensor(v)) for n, v in tree.items()}

def listed(tree):
    return {n: v.tolist() for n, v in tree.items()}

# ---- make_spmd_aggregator: C = 8 over 4 ranks, static groups ----------
stack, losses, sizes = _inputs(8)
fn = spmd.make_spmd_aggregator(mesh, "clients", AGG_CLUSTERS)
shard = spmd.client_shard(mesh, 8)
for do_global in (False, True):
    out = fn(rows_of(stack, shard), shard.local(1.0 / torch.as_tensor(losses)),
             shard.local(torch.as_tensor(sizes)), do_global)
    result[f"agg_{do_global}"] = listed(out)

# ---- merged formulation: C = 16, K = 3, two layouts, no new groups ------
made = []
real_new_group = dist.new_group
dist.new_group = lambda *a, **kw: made.append(a) or real_new_group(*a, **kw)
calls = [0]
real_tree = ops.weighted_agg_multi_tree
def counting(*a, **kw):
    calls[0] += 1
    return real_tree(*a, **kw)
ops.weighted_agg_multi_tree = counting
stack, losses, sizes = _inputs(16, 1)
shard = spmd.client_shard(mesh, 16)
for li, layout in enumerate(LAYOUTS):
    for do_global in (False, True):
        out = spmd.hierarchical_round_sharded(
            rows_of(stack, shard), torch.as_tensor(losses),
            torch.as_tensor(sizes), torch.as_tensor(layout, dtype=torch.int32),
            3, do_global, shard=shard, use_kernels=True)
        assert all(v.shape[0] == 4 for v in out.values())
        result[f"dyn_{li}_{do_global}"] = listed(out)
dist.new_group = real_new_group
ops.weighted_agg_multi_tree = real_tree
result["new_groups"] = len(made)
result["stage1_calls"] = calls[0]

# ---- hierarchical_agg_shard: one client a rank, groups made once -------
stack, losses, sizes = _inputs(4, 2)
for ci, clusters in enumerate((((0, 1), (2, 3)), ((0, 2, 3), (1,)))):
    groups = spmd.make_cluster_groups(clusters)
    local = {n: torch.as_tensor(v[rank]) for n, v in stack.items()}
    for do_global in (False, True):
        out = spmd.hierarchical_agg_shard(
            local, 1.0 / float(losses[rank]), float(sizes[rank]), do_global,
            groups=groups)
        result[f"shard_{ci}_{do_global}"] = listed(out)

# ---- buffered flush ------------------------------------------------------
stack, losses, sizes = _inputs(16, 3)
g = np.random.default_rng(4)
contrib_w = torch.as_tensor(
    np.where(g.uniform(size=16) < 0.4, 0.0, g.uniform(0.2, 1.0, 16)),
    dtype=torch.float32)
old = {n: torch.as_tensor(g.standard_normal((3,) + v.shape[1:]),
                          dtype=torch.float32) for n, v in stack.items()}
flush = torch.tensor([True, False, True])
assignment = torch.as_tensor(LAYOUTS[0], dtype=torch.int32)
for lr in (1.0, 0.5):
    got = spmd.buffered_flush_sharded(
        rows_of(stack, shard), torch.as_tensor(losses), torch.as_tensor(sizes),
        assignment, 3, contrib_w, flush, old, shard=shard, server_lr=lr)
    want = agg.buffered_flush(
        {n: torch.as_tensor(v) for n, v in stack.items()},
        torch.as_tensor(losses), torch.as_tensor(sizes), assignment, 3,
        contrib_w, flush, old, server_lr=lr)
    result[f"flush_{lr}"] = max(float((got[n] - want[n]).abs().max())
                                for n in got)

# ---- the gathers are exact ----------------------------------------------
full = torch.as_tensor(stack["a"])
assert torch.equal(shard.gather(shard.local(full)), full)
table = torch.as_tensor(g.standard_normal((16, 16)), dtype=torch.float32)
ps = torch.tensor([13, 0, 6])
assert torch.equal(shard.ps_rows(shard.local(table), ps), table[ps])
mean = shard.mean_rows({"a": shard.local(full)})["a"]
result["mean_err"] = float((mean - full.mean(0)).abs().max())
"""

LAYOUTS = [[i % 3 for i in range(16)], [i // 6 for i in range(16)]]
AGG_CLUSTERS = ((0, 1, 2, 3), (4, 5, 6, 7))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(W, BODY, tmp_path_factory.mktemp("spmd"), tag="spmd")


def _rows(ranks, key):
    """The full (C, ...) result from each rank's rows, in rank order."""
    return {n: np.concatenate([np.asarray(r[key][n], np.float32)
                               for r in ranks]) for n in ranks[0][key]}


def _err(a, b):
    return max(float(np.max(np.abs(a[n] - b[n]))) for n in a)


@pytest.mark.parametrize("do_global", [False, True])
def test_spmd_aggregator_matches_oracles(ranks, do_global):
    stack, losses, sizes = _inputs(8)
    assignment = [0] * 4 + [1] * 4
    got = _rows(ranks, f"agg_{do_global}")
    assert _err(got, _jax_round(stack, losses, sizes, assignment, 2,
                                do_global)) < TOL
    assert _err(got, _torch_round(stack, losses, sizes, assignment, 2,
                                  do_global)) < TOL


@pytest.mark.parametrize("layout", [0, 1])
@pytest.mark.parametrize("do_global", [False, True])
def test_merged_formulation_dynamic_assignment(ranks, layout, do_global):
    """Two cluster layouts, both branches, one set of process groups: the
    assignment is data.  Each rank runs the stage-1 route once a call."""
    stack, losses, sizes = _inputs(16, 1)
    got = _rows(ranks, f"dyn_{layout}_{do_global}")
    want = _jax_round(stack, losses, sizes, LAYOUTS[layout], 3, do_global)
    assert _err(got, want) < TOL
    assert all(r["new_groups"] == 0 for r in ranks)
    assert all(r["stage1_calls"] == 4 for r in ranks)


@pytest.mark.parametrize("clusters", [0, 1])
@pytest.mark.parametrize("do_global", [False, True])
def test_hierarchical_agg_shard_on_cluster_groups(ranks, clusters,
                                                  do_global):
    stack, losses, sizes = _inputs(4, 2)
    assignment = ([0, 0, 1, 1], [0, 1, 0, 0])[clusters]
    got = {n: np.stack([np.asarray(r[f"shard_{clusters}_{do_global}"][n],
                                   np.float32) for r in ranks])
           for n in stack}
    assert _err(got, _jax_round(stack, losses, sizes, assignment,
                                2, do_global)) < TOL
    assert _err(got, _torch_round(stack, losses, sizes, assignment,
                                  2, do_global)) < TOL


def test_buffered_flush_and_gathers(ranks):
    for r in ranks:
        assert r["flush_1.0"] < TOL and r["flush_0.5"] < TOL, r
        assert r["mean_err"] < TOL, r
