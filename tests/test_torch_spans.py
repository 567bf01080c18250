"""The port's profiler spans (`repro_torch/obs/trace.py`) on the CPU.

* A ``torch.profiler`` capture of a smoke fedhc run that re-clusters and
  evaluates shows each ``fed_step/*`` span once a round it runs in,
  telemetry on or off, and one ``host_read/*`` span a counted host read;
  none of them holds another.
* A capture of a smoke Mixtral train step (remat on) shows
  ``moe/experts`` and ``attention/core`` in forward, in backward (opened
  in the output marker's backward, closed in the input marker's) and in
  the remat recompute, and ``lm_train/update`` outside them.
* Without a capture no span opens and no marker node enters the autograd
  graph; with and without one the results are equal bit for bit: the
  sync history and final stack, the Mixtral stack and loss.
"""
import collections
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import configs as tconfigs
from repro_torch.configs.shapes import InputShape
from repro_torch.core import aggregation as tagg
from repro_torch.core import engine as tengine
from repro_torch.core.fedhc import FLRunConfig
from repro_torch.launch import steps as tsteps
from repro_torch.models import model as tmodel
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(1)

# 4-minute rounds and Z = 0.2: the re-cluster branch fires
FEDHC = dict(method="fedhc", num_clients=16, num_clusters=3, rounds=6,
             rounds_per_global=2, dropout_threshold=0.2, round_minutes=4.0,
             samples_per_client=16, batch_size=8, local_steps=1,
             eval_size=64, eval_every=3)
ARCH = "mixtral-8x22b"
S, BATCH, C = 24, 4, 2
LAYER_SPANS = ("moe/experts", "attention/core")
EVAL = "autograd::engine::evaluate_function: "


def _events(fn):
    """(fn's result, [(name, start_us, end_us)] of the capture)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [(e.name, e.time_range.start, e.time_range.end)
                 for e in prof.events()]


def _sync():
    cfg = FLRunConfig(**FEDHC)
    state0, data = tengine.setup(cfg, device="cpu")
    return cfg, state0, data


def _moe_step():
    """The smoke Mixtral's one-device train step (its profile's scan
    dispatch and remat, float32), its client stack and a batch."""
    cfg = tconfigs.smoke_variant(tconfigs.get_config(ARCH))
    prof = dataclasses.replace(tconfigs.get_profile(ARCH),
                               param_dtype="float32",
                               accum_dtype="float32", remat=True)
    assert prof.moe_dispatch == "scan"
    bundle = tsteps.build_train_step(
        ARCH, InputShape("t", S, BATCH, "train"), None, num_clusters=1,
        num_clients=C, cfg=cfg, profile=prof)
    p = tmodel.init_params(dataclasses.replace(cfg, dtype="float32"),
                           torch.Generator().manual_seed(0))
    stack = tree_map(torch.clone, tagg.broadcast_global(p, C))
    toks = torch.randint(0, cfg.vocab_size, (C, BATCH // C, S + 1),
                         generator=torch.Generator().manual_seed(1))
    return bundle, stack, {"tokens": toks[..., :-1],
                           "labels": toks[..., 1:]}


def _inside(t, spans):
    return any(s <= t <= e for s, e in spans)


@pytest.mark.parametrize("telemetry", [False, True])
def test_round_spans_under_a_capture(telemetry):
    cfg, state0, data = _sync()
    cfg = dataclasses.replace(cfg, telemetry=telemetry)
    tengine.reset_host_reads()
    (_, outs), events = _events(lambda: tengine.simulate(
        cfg, device="cpu", state0=state0, data=data))
    outs = tengine.split_outputs(outs)[0]
    assert outs.reclustered.sum() >= 1 and outs.evaluated.sum() >= 1
    count = collections.Counter(n for n, _, _ in events)
    want = {"fed_step/local_train": cfg.rounds,
            "fed_step/aggregate": cfg.rounds,
            "fed_step/recluster": int(outs.reclustered.sum()),
            "fed_step/eval": int(outs.evaluated.sum())}
    if telemetry:
        want["fed_step/telemetry"] = cfg.rounds
    assert {n: c for n, c in count.items()
            if n.startswith("fed_step/")} == want
    assert {n: c for n, c in count.items() if n.startswith("host_read/")} \
        == {f"host_read/{k}": v for k, v in tengine.HOST_READS.items() if v}
    assert tengine.HOST_READS["recluster"] == cfg.rounds // 2
    assert tengine.HOST_READS["fetch"] == 1
    # side by side: no span of the round holds another
    spans = sorted((s, e) for n, s, e in events
                   if n.startswith(("fed_step/", "host_read/")))
    assert all(e0 <= s1 for (_, e0), (s1, _) in zip(spans, spans[1:]))


def test_layer_spans_cover_backward_and_recompute():
    bundle, stack, batch = _moe_step()
    _, events = _events(lambda: bundle.fn(stack, batch, 0))
    evals = {}
    for n, s, e in events:
        if n.startswith(EVAL):
            evals.setdefault(n[len(EVAL):], []).append((s, e))
    every_eval = [r for rs in evals.values() for r in rs]
    opens = evals["_OpenInBackwardBackward"]
    closes = evals["_CloseInBackwardBackward"]
    layers = tconfigs.smoke_variant(tconfigs.get_config(ARCH)).num_layers
    trips = C * bundle.meta["accum"] * layers
    by_kind = {}
    for name in LAYER_SPANS:
        ranges = [(s, e) for n, s, e in events if n == name]
        fwd = [r for r in ranges if not _inside(r[0], every_eval)]
        bwd = [r for r in ranges if _inside(r[0], opens)]
        recompute = [r for r in ranges if r not in fwd and r not in bwd]
        # one forward, one backward and one recompute a layer a trip
        assert len(fwd) == len(bwd) == len(recompute) == trips, name
        # backward: opened as the output's gradient arrives, closed as
        # the inputs' leave, and the layer's backward nodes inside
        assert all(_inside(e, closes) for _, e in bwd), name
        for s, e in bwd:
            assert any(s < s2 and e2 < e for s2, e2 in every_eval), name
        by_kind[name] = (fwd, bwd, recompute)
    moe_bwd = by_kind["moe/experts"][1]
    # the remat recompute of the whole layer runs inside the backward
    # range of its last region, the experts (the benchmark's readers take
    # the attention's recompute out of the experts' time)
    for name in LAYER_SPANS:
        assert all(_inside(s, moe_bwd) for s, _ in by_kind[name][2]), name
    # the attention's backward runs after the experts' range closed
    attention_bwd = by_kind["attention/core"][1]
    assert not any(_inside(s, moe_bwd) for s, _ in attention_bwd)
    update = [(s, e) for n, s, e in events if n == "lm_train/update"]
    assert len(update) == C * (bundle.meta["accum"] + 1)
    layer = [r for name in LAYER_SPANS for rs in by_kind[name] for r in rs]
    assert not any(_inside(s, layer) or _inside(e, layer) for s, e in update)


def _graph_nodes(loss):
    seen, todo = set(), [loss.grad_fn]
    while todo:
        f = todo.pop()
        if f is None or f in seen:
            continue
        seen.add(f)
        todo.extend(g for g, _ in f.next_functions)
    return {type(f).__name__ for f in seen}


def test_no_capture_opens_nothing_and_adds_no_node(monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def counting(name, *a):
        opened.append(name)
        return real(name, *a)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    cfg, state0, data = _sync()
    tengine.simulate(cfg, device="cpu", state0=state0, data=data)
    bundle, stack, batch = _moe_step()
    bundle.fn(stack, batch, 0)
    assert opened == []

    tcfg = tconfigs.smoke_variant(tconfigs.get_config(ARCH))
    p = tmodel.init_params(tcfg, torch.Generator().manual_seed(2))
    for x in tree_leaves(p):
        x.requires_grad_(True)
    toks = torch.randint(0, tcfg.vocab_size, (2, S))

    def loss():
        return tmodel.loss_fn(tcfg, p, {"tokens": toks, "labels": toks},
                              dispatch="scan", remat=True)[0]
    plain = _graph_nodes(loss())
    captured, _ = _events(lambda: _graph_nodes(loss()))
    markers = {"_OpenInBackwardBackward", "_CloseInBackwardBackward"}
    assert not plain & markers
    assert captured - plain == markers


def test_results_equal_with_and_without_a_capture():
    cfg, state0, data = _sync()
    runs = [tengine.simulate(cfg, device="cpu", state0=state0, data=data)]
    runs.append(_events(lambda: tengine.simulate(
        cfg, device="cpu", state0=state0, data=data))[0])
    (s0, o0), (s1, o1) = runs
    for a, b in zip(o0, o1):
        np.testing.assert_array_equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(s0.params),
                                                 tree_leaves(s1.params)))

    bundle, stack, batch = _moe_step()
    copies = [tree_map(torch.clone, stack) for _ in range(2)]
    (st0, l0) = bundle.fn(copies[0], batch, 0)
    (st1, l1), _ = _events(lambda: bundle.fn(copies[1], batch, 0))
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(st0),
                                                 tree_leaves(st1)))
