"""One-call experiment API: ``run(scenario) -> RunResult`` and
``run_sweep(scenario, seeds) -> SweepResult``.

Counterpart of ``repro/api.py`` (``cuda`` unless ``device="cpu"`` is
passed).  ``scenario.exec.mesh_devices`` (or an explicit ``mesh=``) runs
on a client mesh (`launch/mesh.py`): every rank of the process group the
caller initialized calls :func:`run` alike, holds its own rows of the
client stack and returns the same result, ``mesh_shape`` ``{"clients":
W}``; without a process group it raises.  Routing is the reference's:
sync strategies (always-up and visibility-gated) run on
`core/engine.py`, async ones (fedbuff, fedhc-async, fedspace-async) on
`core/async_engine.py`.
:class:`RunResult` and :class:`SweepResult` have the reference's fields,
``time_to_accuracy`` (paper Table I's metric) and JSON ``save``/``load``
in the reference's format, key for key, so a file written by either
package loads in the other, telemetry included.  ``compile_s`` is the time
spent building the CUDA kernels at first use (~0 afterwards, and 0 on the
CPU); the reference's AOT compile cache has no counterpart, since PyTorch
runs eagerly.

``scenario.exec.telemetry`` turns on both observability planes
(`repro_torch.obs`): the engines' per-round :class:`Telemetry` records,
carried by the run's one device-to-host copy, and host spans around
setup / compile / run / fetch, surfaced as ``RunResult.telemetry`` and
rendered by ``python -m repro_torch.obs.report``.  The setup-cache
counters (``api.setup_cache.hit/miss`` in ``obs.trace.COUNTERS``) count
on every call that passes a ``setup_cache``, telemetry on or off.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import sys
import time
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core import async_engine
from repro_torch.core import engine
from repro_torch.core import strategies as strat_lib
from repro_torch.core.scenario import (AsyncSpec, CommsSpec, DataSpec,
                                       ExecSpec, FleetSpec, Scenario,
                                       TrainSpec)
from repro_torch.kernels import build
from repro_torch.launch import mesh as mesh_lib
from repro_torch.obs.telemetry import RunTelemetry, rounds_from_scan
from repro_torch.obs.trace import COUNTERS, Counters, Tracer

__all__ = [
    "Scenario", "DataSpec", "FleetSpec", "TrainSpec", "CommsSpec",
    "AsyncSpec", "ExecSpec", "RunResult", "SweepResult", "TimeToAccuracy",
    "run", "run_sweep",
]


class TimeToAccuracy(NamedTuple):
    """First eval point at or after which accuracy reached the target."""
    time_s: float
    energy_j: float
    round: int


def _write_json(path: str, d: Dict[str, Any]) -> None:
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "w") as f:
        json.dump(d, f, indent=2)


@dataclass
class RunResult:
    """Typed result of one :func:`run` call (the reference's fields)."""
    scenario: Scenario
    round: np.ndarray          # (E,) int: 1-based eval round index
    acc: np.ndarray            # (E,) f64 test accuracy
    loss: np.ndarray           # (E,) f64 training loss
    time_s: np.ndarray         # (E,) f64 cumulative simulated time
    energy_j: np.ndarray       # (E,) f64 cumulative simulated energy
    reclusters: int
    global_rounds: int         # stage-2 aggregations that fired
    strategy: Dict[str, str]   # resolved Strategy axes (registry entry)
    mesh_shape: Optional[Dict[str, int]]   # None: one device
    setup_s: float             # host: one-time setup (contact plan included)
    compile_s: float           # host: CUDA kernel build at first use
    run_s: float               # host: the rounds + the history fetch
    flushes: Optional[int] = None          # async engines only
    mean_staleness: Optional[float] = None
    peak_device_mem_mb: Optional[float] = None  # CUDA peak allocation
    peak_host_mem_mb: Optional[float] = None    # host peak RSS
    telemetry: Optional[RunTelemetry] = None    # both obs planes when
    #                            ExecSpec.telemetry is on: per-round
    #                            device series + host spans + counters

    @property
    def wall_s(self) -> float:
        """Total host wall-clock: setup + compile + run."""
        return self.setup_s + self.compile_s + self.run_s

    @property
    def final_acc(self) -> float:
        return float(self.acc[-1])

    def time_to_accuracy(self, target: float) -> Optional[TimeToAccuracy]:
        """First ``(time_s, energy_j, round)`` at which accuracy reached
        ``target``, or None when it never did (`core/fedhc.py`'s
        ``time_energy_to_accuracy`` keeps the ``(inf, inf, -1)``
        sentinel for history dicts)."""
        for r, a, t, e in zip(self.round, self.acc, self.time_s,
                              self.energy_j):
            if a >= target:
                return TimeToAccuracy(float(t), float(e), int(r))
        return None

    def to_history(self) -> Dict[str, Any]:
        """The ``engine.run``-style history dict (async runs add their
        ``flushes`` and ``mean_staleness``)."""
        h: Dict[str, Any] = {
            "round": [int(r) for r in self.round],
            "acc": [float(a) for a in self.acc],
            "loss": [float(x) for x in self.loss],
            "time_s": [float(t) for t in self.time_s],
            "energy_j": [float(e) for e in self.energy_j],
            "reclusters": self.reclusters,
            "global_rounds": self.global_rounds,
        }
        if self.flushes is not None:
            h["flushes"] = self.flushes
            h["mean_staleness"] = self.mean_staleness
        return h

    def save(self, path: str) -> None:
        """JSON result with its scenario manifest, the reference's
        format key for key."""
        _write_json(path, {
            "scenario": self.scenario.to_dict(),
            "history": self.to_history(),
            "strategy": self.strategy,
            "mesh_shape": self.mesh_shape,
            "timings": {"setup_s": self.setup_s,
                        "compile_s": self.compile_s,
                        "run_s": self.run_s,
                        "peak_device_mem_mb": self.peak_device_mem_mb,
                        "peak_host_mem_mb": self.peak_host_mem_mb},
            "telemetry": (self.telemetry.to_dict()
                          if self.telemetry is not None else None),
        })

    @classmethod
    def load(cls, path: str) -> "RunResult":
        """A result saved by either package, its telemetry record
        included."""
        with open(path) as f:
            d = json.load(f)
        h, t = d["history"], d["timings"]
        return cls(
            scenario=Scenario.from_dict(d["scenario"]),
            round=np.asarray(h["round"], np.int64),
            acc=np.asarray(h["acc"], np.float64),
            loss=np.asarray(h["loss"], np.float64),
            time_s=np.asarray(h["time_s"], np.float64),
            energy_j=np.asarray(h["energy_j"], np.float64),
            reclusters=h["reclusters"],
            global_rounds=h["global_rounds"],
            strategy=d["strategy"],
            mesh_shape=d["mesh_shape"],
            setup_s=t["setup_s"], compile_s=t["compile_s"],
            run_s=t["run_s"],
            flushes=h.get("flushes"),
            mean_staleness=h.get("mean_staleness"),
            peak_device_mem_mb=t.get("peak_device_mem_mb"),
            peak_host_mem_mb=t.get("peak_host_mem_mb"),
            telemetry=(RunTelemetry.from_dict(d["telemetry"])
                       if d.get("telemetry") else None),
        )


@dataclass
class SweepResult:
    """Typed result of :func:`run_sweep`: per-seed per-round arrays of
    shape ``(num_seeds, rounds)``; mask columns by ``evaluated`` (the same
    cadence every seed) for the eval points."""
    scenario: Scenario
    seeds: np.ndarray          # (S,)
    acc: np.ndarray            # (S, R), NaN on non-eval rounds
    loss: np.ndarray           # (S, R)
    time_s: np.ndarray         # (S, R)
    energy_j: np.ndarray       # (S, R)
    evaluated: np.ndarray      # (S, R) bool
    reclusters: np.ndarray     # (S,) per-seed totals
    global_rounds: np.ndarray  # (S,)
    wall_s: float

    @property
    def eval_rounds(self) -> np.ndarray:
        """1-based round indices of the eval points."""
        return np.nonzero(self.evaluated[0])[0] + 1

    def eval_curves(self, key: str = "acc") -> np.ndarray:
        """(S, E) per-seed values at the eval points only."""
        return getattr(self, key)[:, np.nonzero(self.evaluated[0])[0]]

    @property
    def final_acc(self) -> np.ndarray:
        """(S,) last-eval-point accuracy per seed."""
        return self.eval_curves("acc")[:, -1]

    def save(self, path: str) -> None:
        """JSON sweep with its manifest, the reference's format; NaN (a
        non-eval round) is written as JSON ``null``."""
        def col(a):
            a = np.asarray(a, np.float64)
            return [[None if np.isnan(x) else float(x) for x in row]
                    for row in a]
        _write_json(path, {
            "scenario": self.scenario.to_dict(),
            "seeds": [int(x) for x in self.seeds],
            "acc": col(self.acc), "loss": col(self.loss),
            "time_s": col(self.time_s), "energy_j": col(self.energy_j),
            "evaluated": np.asarray(self.evaluated, bool).tolist(),
            "reclusters": [int(x) for x in self.reclusters],
            "global_rounds": [int(x) for x in self.global_rounds],
            "wall_s": self.wall_s,
        })

    @classmethod
    def load(cls, path: str) -> "SweepResult":
        with open(path) as f:
            d = json.load(f)

        def col(rows):
            return np.asarray([[np.nan if x is None else x for x in row]
                               for row in rows], np.float64)
        return cls(
            scenario=Scenario.from_dict(d["scenario"]),
            seeds=np.asarray(d["seeds"], np.int64),
            acc=col(d["acc"]), loss=col(d["loss"]),
            time_s=col(d["time_s"]), energy_j=col(d["energy_j"]),
            evaluated=np.asarray(d["evaluated"], bool),
            reclusters=np.asarray(d["reclusters"], np.int64),
            global_rounds=np.asarray(d["global_rounds"], np.int64),
            wall_s=d["wall_s"])


def _peak_host_mem_mb() -> Optional[float]:
    try:
        import resource
    except ImportError:          # not on every platform
        return None
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    scale = 1.0 if sys.platform == "darwin" else 1024.0
    return round(float(peak) * scale / 1e6, 3)


def _setup_cache_key(cfg, dev, mesh, caxes):
    """Setup does not read the execution-only knobs (microbatch, kernel
    routing, telemetry): runs that differ only in them share one.  A
    setup on a mesh holds that mesh's rows, so the mesh is in the key."""
    return (dataclasses.replace(cfg, client_microbatch=0,
                                use_pallas_kernels=False, telemetry=False),
            dev, mesh, caxes)


def _resolve_mesh(scenario: Scenario, mesh, dev):
    """An explicit ``mesh=`` wins; otherwise the ExecSpec's (``None`` =>
    one device, ``0`` => every rank of the process group)."""
    if mesh is not None:
        return mesh
    md = scenario.exec.mesh_devices
    if md is None:
        return None
    return mesh_lib.make_client_mesh(md, device_type=dev.type)


def run(scenario: Scenario, *, device=None, verbose: bool = False,
        mesh=None, client_axes=None,
        setup_cache: Optional[Dict[Any, Any]] = None) -> RunResult:
    """Run one scenario end to end on ``device`` (default ``cuda``).

    ``mesh=``/``client_axes=`` override the ExecSpec's placement for a
    caller that already holds a client mesh (module docstring).

    ``setup_cache``: a dict owned by the caller; runs that differ only in
    execution knobs (microbatch, kernel routing, telemetry) reuse one
    setup (data, model, clustering, contact plan), and a hit reports
    ``setup_s ~ 0``.  Safe because a run never writes into its setup's
    tensors."""
    dev = device_lib.resolve(device)
    cfg = scenario.to_flat()
    strategy = strat_lib.get(cfg.method)
    eng = async_engine if strategy.is_async else engine
    mesh = _resolve_mesh(scenario, mesh, dev)
    caxes = client_axes if client_axes is not None \
        else scenario.exec.client_axes
    if mesh is not None and caxes is None:
        caxes = mesh_lib.mesh_axes(mesh)          # every axis carries clients
    if mesh is not None and strategy.shardable:
        mesh_lib.validate_client_sharding(mesh, caxes, cfg.num_clients)

    # host-plane observability: a span tracer when telemetry is on (the
    # spans ride RunResult.telemetry), setup-cache counters always
    telem_on = cfg.telemetry
    tracer = Tracer(nvtx=dev.type == "cuda") if telem_on else None
    counters0 = COUNTERS.snapshot() if telem_on else {}

    def span(name):
        return (tracer.span(name) if tracer is not None
                else contextlib.nullcontext())

    # the kernel build is the port's "compile" (the reference's "lower"
    # has no counterpart: eager PyTorch traces no program)
    t0 = time.perf_counter()
    with span("compile"):
        if cfg.use_pallas_kernels and dev.type == "cuda":
            build.build_all()
    compile_s = time.perf_counter() - t0

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    key = (_setup_cache_key(cfg, dev, mesh, caxes)
           if setup_cache is not None else None)
    if key is not None and key in setup_cache:
        COUNTERS.inc("api.setup_cache.hit")
        state0, data = setup_cache[key]
    else:
        if key is not None:
            COUNTERS.inc("api.setup_cache.miss")
        with span("setup"):
            state0, data = eng.setup(cfg, device=dev, mesh=mesh,
                                     client_axes=caxes)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        if key is not None:
            setup_cache[key] = (state0, data)
    setup_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    with span("run"):              # the rounds, ending in the one fetch
        _, outs = eng.simulate(cfg, device=dev, state0=state0, data=data,
                               mesh=mesh, client_axes=caxes)
    round_outs, telem = engine.split_outputs(outs)
    with span("fetch"):
        history = eng.history_from_outputs(round_outs)
    run_s = time.perf_counter() - t0
    if verbose:
        engine._print_history(history, cfg.method,
                              "event" if strategy.is_async else "round")

    return RunResult(
        scenario=scenario,
        round=np.asarray(history["round"], np.int64),
        acc=np.asarray(history["acc"], np.float64),
        loss=np.asarray(history["loss"], np.float64),
        time_s=np.asarray(history["time_s"], np.float64),
        energy_j=np.asarray(history["energy_j"], np.float64),
        reclusters=history["reclusters"],
        global_rounds=history["global_rounds"],
        strategy=dataclasses.asdict(strategy),
        mesh_shape=(mesh_lib.mesh_shape(mesh) if mesh is not None
                    else None),
        setup_s=round(setup_s, 4), compile_s=round(compile_s, 4),
        run_s=round(run_s, 4),
        flushes=history.get("flushes"),
        mean_staleness=history.get("mean_staleness"),
        peak_device_mem_mb=device_lib.peak_device_mem_mb(dev),
        peak_host_mem_mb=_peak_host_mem_mb(),
        telemetry=(RunTelemetry(
            rounds=rounds_from_scan(telem), spans=tracer.span_dicts(),
            counters=Counters.delta(counters0, COUNTERS.snapshot()))
            if telem_on else None),
    )


def run_sweep(scenario: Scenario, seeds: Sequence[int], *,
              device=None) -> SweepResult:
    """Multi-seed sweep (`engine.run_many_seeds`: one contact plan, a loop
    over seeds); ``scenario.seed`` is ignored in favor of ``seeds``.  Sync
    single-device strategies only: the reference's ``ValueError``s for
    async methods and a mesh, before any setup."""
    strategy = strat_lib.get(scenario.method)
    if strategy.is_async:
        raise ValueError(
            f"run_sweep is sync-only: {scenario.method!r} uses "
            f"async-buffered aggregation (vmapping the event scan over "
            f"seeds is an open ROADMAP item). Loop run() over seeds "
            f"instead.")
    if scenario.exec.mesh_devices is not None:
        raise ValueError(
            "run_sweep does not support a client mesh yet "
            "(run_many_seeds vmaps the single-program scan; sharding the "
            "seed x client axes is an open ROADMAP item). Set "
            "ExecSpec(mesh_devices=None), or loop run() over seeds for "
            "sharded execution.")
    dev = device_lib.resolve(device)
    cfg = scenario.to_flat()
    if cfg.use_pallas_kernels and dev.type == "cuda":
        build.build_all()
    t0 = time.perf_counter()
    sweep = engine.run_many_seeds(cfg, seeds, device=dev)
    wall_s = time.perf_counter() - t0
    return SweepResult(
        scenario=scenario, seeds=sweep["seeds"], acc=sweep["acc"],
        loss=sweep["loss"], time_s=sweep["time_s"],
        energy_j=sweep["energy_j"], evaluated=sweep["evaluated"],
        reclusters=sweep["reclusters"],
        global_rounds=sweep["global_rounds"], wall_s=round(wall_s, 4))
