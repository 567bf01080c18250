"""Bridge from the JAX reference to the PyTorch port's inputs.

A test helper, not part of the port (which imports nothing of ``repro``):
it runs ``repro.core.engine.setup`` and hands its arrays over as numpy,
and it precomputes the per-round draws with the reference's own
expressions, so the port can replay the reference's randomness
(``repro_torch.core.engine.state_from_numpy`` + ``ArrayDraws``).  Other
test files import it by basename.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import engine as jengine
from repro.core import strategies as jstrat
from repro.core.fedhc import FLRunConfig as JaxConfig
from repro.data.synthetic import client_batches as jax_client_batches

from repro_torch.core import async_engine as tasync
from repro_torch.core import engine as tengine
from repro_torch.core.fedhc import FLRunConfig as TorchConfig

# The suite runs several worker processes at once; torch's intra-op thread
# pool would oversubscribe the cores (and one thread makes the port's CPU
# results independent of the machine's core count).
torch.set_num_threads(1)


def reference_plan_to_numpy(plan):
    """A reference contact plan in the layout the port's
    ``orbits.contact.plan_from_numpy`` takes: ``{"kind": class name,
    field: numpy array or plain value}``, a factorized plan's
    constellation and link parameters as field dicts."""
    if dataclasses.is_dataclass(plan):              # FactorizedContactPlan
        fields = {f.name: getattr(plan, f.name)
                  for f in dataclasses.fields(plan)}
        fields["constellation"] = dataclasses.asdict(plan.constellation)
        fields["link_params"] = dataclasses.asdict(plan.link_params)
    else:
        fields = plan._asdict()
    return {"kind": type(plan).__name__,
            **{k: (np.asarray(v) if isinstance(v, jax.Array) else v)
               for k, v in fields.items()}}


def reference_setup(cfg: JaxConfig):
    """``(arrays, state0, data)``: the reference's setup, with the arrays
    the port's ``state_from_numpy`` takes (its contact plan under
    ``"plan"`` when the strategy is visibility-gated)."""
    state0, data = jengine.setup(cfg)
    strategy = jstrat.get(cfg.method)
    w0 = (state0.params if strategy.centralized
          else jax.tree_util.tree_map(lambda x: x[0], state0.params))
    arrays = {
        "images": data.images, "labels": data.labels,
        "test_x": data.test_x, "test_y": data.test_y,
        "client_idx": data.client_idx, "freqs": data.freqs,
        "assignment0": state0.assignment, "centroids0": state0.centroids,
        "ps_index0": state0.ps_index,
        "w0": jax.tree_util.tree_map(np.asarray, w0),
    }
    arrays = {k: (v if k == "w0" else np.asarray(v))
              for k, v in arrays.items()}
    if data.plan is not None:
        arrays["plan"] = reference_plan_to_numpy(data.plan)
    return arrays, state0, data


def reference_draws(cfg: JaxConfig, state0, data):
    """The per-round draws of the reference's round scan:
    ``batch_picks`` (R, C, B), ``kmeans_init`` (R, K) and
    ``central_picks`` (R, max(steps, 1), B).  ``batch_picks`` are also the
    async engine's per-event picks: its event scan draws them with the
    same expression, full cohort or partial
    (``repro/core/async_engine.py``; held by
    ``test_bridged_draws_are_the_async_event_picks``)."""
    strategy = jstrat.get(cfg.method)
    k = 1 if strategy.centralized else cfg.num_clusters
    n = cfg.num_clients
    n_total = n * cfg.samples_per_client
    rounds = jnp.arange(cfg.rounds)
    steps = jnp.arange(max(cfg.local_steps, 1))
    batch = jax.vmap(lambda r: jax.random.randint(
        jax.random.fold_in(state0.rng, r),
        (n, cfg.batch_size), 0, cfg.samples_per_client))(rounds)
    kinit = jax.vmap(lambda r: jax.random.choice(
        jax.random.fold_in(data.r_kmeans, r), n, (k,),
        replace=False))(rounds)
    central = jax.vmap(lambda r: jax.vmap(lambda s: jax.random.randint(
        jax.random.fold_in(jax.random.fold_in(state0.rng, r), s),
        (cfg.batch_size,), 0, n_total))(steps))(rounds)
    return np.asarray(batch), np.asarray(kinit), np.asarray(central)


def bridged(device="cpu", golden_streams=False, **cfg_kwargs):
    """``(torch_cfg, state0, data, draws, jax_cfg)`` for one config: the
    port's run inputs taken from the reference's setup, draws and contact
    plan (``state0`` the async engine's state for an async method).

    ``golden_streams`` draws with JAX's non-partitionable threefry, the
    random streams ``tests/golden/engine_always.json`` was captured under
    (JAX's default has since changed, which changes every draw)."""
    jcfg = JaxConfig(**cfg_kwargs)
    tcfg = TorchConfig(**cfg_kwargs)
    with jax.threefry_partitionable(not golden_streams):
        arrays, jstate0, jdata = reference_setup(jcfg)
        draws = reference_draws(jcfg, jstate0, jdata)
    eng = tasync if jstrat.get(jcfg.method).is_async else tengine
    state0, data = eng.state_from_numpy(tcfg, arrays, device=device)
    return (tcfg, state0, data, tengine.ArrayDraws(*draws, device=device),
            jcfg)


def test_bridged_draws_replay_reference_batches():
    """The bridged batch picks gather exactly the minibatches the
    reference's ``client_batches`` draws in each round, and the k-means
    draws are without replacement."""
    from types import SimpleNamespace
    cfg = JaxConfig(method="fedhc", num_clients=8, num_clusters=2, rounds=3,
                    samples_per_client=16, batch_size=8)
    g = np.random.default_rng(0)
    images = jnp.asarray(g.standard_normal((128, 28, 28, 1)), jnp.float32)
    labels = jnp.asarray(g.integers(0, 10, 128), jnp.int32)
    client_idx = jnp.asarray(g.integers(0, 128, (8, 16)), jnp.int32)
    state0 = SimpleNamespace(rng=jax.random.PRNGKey(7))
    data = SimpleNamespace(r_kmeans=jax.random.PRNGKey(8))
    batch, kinit, central = reference_draws(cfg, state0, data)
    assert batch.shape == (3, 8, 8) and kinit.shape == (3, 2)
    assert central.shape == (3, 2, 8)
    for rnd in range(cfg.rounds):
        imgs, labs = jax_client_batches(
            images, labels, client_idx, jax.random.fold_in(state0.rng, rnd),
            cfg.batch_size)
        flat = np.take_along_axis(np.asarray(client_idx), batch[rnd], axis=1)
        np.testing.assert_array_equal(np.asarray(images)[flat],
                                      np.asarray(imgs))
        np.testing.assert_array_equal(np.asarray(labels)[flat],
                                      np.asarray(labs))
        assert len(set(kinit[rnd].tolist())) == 2


def test_bridged_draws_are_the_async_event_picks():
    """The reference's async event scan draws an event's (C, B) picks with
    the sync round's expression (full cohort: ``client_batches``; partial:
    ``randint`` then a gather of the cohort's rows), so the bridged
    ``batch_picks`` replay them too."""
    cfg = JaxConfig(method="fedhc-async", num_clients=8, num_clusters=2,
                    rounds=3, samples_per_client=16, batch_size=8,
                    async_cohort=3)
    state0, data = jengine.setup(cfg)
    batch, _, _ = reference_draws(cfg, state0, data)
    for step in range(cfg.rounds):
        r_rnd = jax.random.fold_in(state0.rng, step)
        picks = jax.random.randint(r_rnd, (8, cfg.batch_size), 0,
                                   data.client_idx.shape[1])
        np.testing.assert_array_equal(np.asarray(picks), batch[step])
