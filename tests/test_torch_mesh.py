"""The port's sharding rules and mesh helpers against the JAX reference.

* ``sharding/rules``: every case of ``tests/test_sharding_rules.py`` on
  the same ``FakeMesh`` shapes gives the reference's spec (compared as a
  JAX ``PartitionSpec``), and specs turn into DTensor placements.
* ``launch/mesh``: the client-layout helpers raise what the reference
  raises, with its messages; the production shapes are the reference's;
  without a process group a client mesh, and ``api.run`` with
  ``mesh_devices``, raise naming ``torchrun``/``init_process_group``.
"""
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.launch import mesh as jmesh
from repro.sharding import rules as jrules

from repro_torch import api as tapi
from repro_torch.launch import mesh as tmesh
from repro_torch.sharding import rules as trules


class FakeMesh:
    """Duck-typed mesh: the rules read ``.shape``; the layout helpers
    also read ``.axis_names`` (the reference test's)."""
    def __init__(self, shape_dict):
        self.shape = shape_dict
        self.axis_names = tuple(shape_dict)


MESH = {"data": 16, "model": 16}

# (path, shape, mesh shape, kwargs): test_sharding_rules.py's cases
SPEC_CASES = [
    (("layers", "0", "mlp", "w_gate"), (2304, 9216), MESH,
     dict(tp_axes="model")),
    (("mlp", "w_gate"), (8192, 29568), MESH,
     dict(tp_axes="model", fsdp_axes="data")),
    (("attn", "wq"), (100, 9), MESH, dict(tp_axes="model")),
    (("layers", "0", "attn", "wq"), (13, 2304, 2048), MESH,
     dict(tp_axes="model")),
    (("layers", "0", "attn", "wq"), (16, 13, 2304, 2048), MESH,
     dict(tp_axes="model", client_axes=("data",), client_stacked=True)),
    (("moe", "w_gate"), (8, 6144, 32768), MESH, dict(tp_axes="model")),
    (("norm1", "scale"), (2304,), MESH, {}),
] + [
    (("f1", "w"), (800, 256, 120), {"clients": n},
     dict(client_axes=("clients",), client_stacked=True)) for n in (4, 8, 16)
] + [
    (("c1", "b"), (800, 6), {"clients": n},
     dict(client_axes=("clients",), client_stacked=True)) for n in (4, 8, 16)
] + [
    (("mlp", "w_gate"), (800, 2304, 9216), {"clients": n, "model": 4},
     dict(tp_axes="model", client_axes=("clients",), client_stacked=True))
    for n in (4, 8, 16, 3)
]


@pytest.mark.parametrize("path,shape,mesh,kw", SPEC_CASES,
                         ids=lambda v: str(v) if isinstance(v, tuple)
                         and all(isinstance(x, str) for x in v) else None)
def test_spec_for_param_matches_reference(path, shape, mesh, kw):
    want = jrules.spec_for_param(path, shape, FakeMesh(mesh), **kw)
    got = trules.spec_for_param(path, shape, FakeMesh(mesh), **kw)
    assert isinstance(got, trules.PartitionSpec)
    assert JP(*got) == want, (got, want)


@pytest.mark.parametrize("ndev,n", [(4, 800), (8, 800), (16, 800), (3, 800),
                                    (16, 100)])
def test_client_spec_matches_reference(ndev, n):
    m = FakeMesh({"clients": ndev})
    for axes in (("clients",), None):
        assert JP(*trules.client_spec(m, axes, n)) == \
            jrules.client_spec(m, axes, n)


def test_tree_specs_and_placements():
    """The reference's tree walk on the same shapes, and the specs as
    DTensor placements: a dim naming a mesh axis shards over it."""
    from torch.distributed.tensor import Replicate, Shard
    params = {"embed": {"embedding": jax.ShapeDtypeStruct((256000, 2304),
                                                          jnp.bfloat16)},
              "layers": ({"mlp": {"w_down": jax.ShapeDtypeStruct(
                  (13, 9216, 2304), jnp.bfloat16)}},)}
    tparams = {"embed": {"embedding": torch.empty((256000, 2304),
                                                  device="meta")},
               "layers": ({"mlp": {"w_down": torch.empty(
                   (13, 9216, 2304), device="meta")}},)}
    m = FakeMesh(MESH)
    want = jrules.tree_param_specs(params, m, tp_axes="model")
    got = trules.tree_param_specs(tparams, m, tp_axes="model")
    assert JP(*got["embed"]["embedding"]) == want["embed"]["embedding"]
    assert JP(*got["layers"][0]["mlp"]["w_down"]) == \
        want["layers"][0]["mlp"]["w_down"]
    pl = trules.tree_shardings(got, m)
    assert pl["embed"]["embedding"] == (Replicate(), Shard(0))
    assert pl["layers"][0]["mlp"]["w_down"] == (Replicate(), Shard(1))
    stacked = trules.spec_for_param(("c1", "w"), (32, 5, 5, 1, 6),
                                    FakeMesh({"clients": 4}),
                                    client_axes=("clients",),
                                    client_stacked=True)
    assert trules.placements(stacked, FakeMesh({"clients": 4})) == \
        (Shard(0),)


def _raises(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("call", [
    lambda lib, m: lib.client_axes_for(m, "data", num_clients=64),
    lambda lib, m: lib.num_clients_for(m, "data", num_clients=32),
    lambda lib, m: lib.client_axes_for(m, "data", num_clients=100),
    lambda lib, m: lib.validate_client_sharding(m, ("data",), 30),
    lambda lib, m: lib.client_axes_for(m, "pod", num_clients=800),
    lambda lib, m: lib.num_clients_for(m, "pod", num_clients=1),
    lambda lib, m: lib.client_axes_for(m, "pod"),
    lambda lib, m: lib.client_axis_size(m, ("data", "model")),
], ids=["axes-64", "count-32", "indivisible-100", "validate-30",
        "no-client-axes", "pod-1", "pod-unvalidated", "axis-size"])
def test_client_layout_matches_reference(call):
    """The layout helpers return the reference's values and raise its
    errors, message for message."""
    m = FakeMesh({"data": 16, "model": 16})
    want_err = _raises(lambda: call(jmesh, m))
    got_err = _raises(lambda: call(tmesh, m))
    assert got_err == want_err
    if want_err is None:
        assert call(tmesh, m) == call(jmesh, m)


def test_production_shapes_are_the_reference_shapes():
    assert tmesh.PRODUCTION_SHAPE == ((16, 16), ("data", "model"))
    assert tmesh.MULTI_POD_SHAPE == ((2, 16, 16), ("pod", "data", "model"))
    assert tmesh.process_local_client_rows(800) == 800   # one process


def test_no_process_group_raises():
    """Without an initialized process group nothing runs unsharded in
    silence: the mesh, and api.run with mesh_devices, raise and say how to
    start one."""
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="torchrun"):
        tmesh.make_client_mesh(0, device_type="cpu")
    sc = tapi.Scenario(fleet=tapi.FleetSpec(num_clients=8, num_clusters=2),
                       exec=tapi.ExecSpec(mesh_devices=0))
    with pytest.raises(RuntimeError, match="init_process_group"):
        tapi.run(sc, device="cpu")
