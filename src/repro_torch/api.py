"""One-call experiment API: ``run(scenario) -> RunResult``.

Counterpart of ``repro/api.py`` for this slice: synchronous, always-up
strategies on one device (``cuda`` unless ``device="cpu"`` is passed).
:class:`RunResult` has the reference's fields.  ``compile_s`` is the time
spent building the CUDA kernels at first use (~0 afterwards, and 0 on the
CPU); the reference's AOT compile cache has no counterpart, since PyTorch
runs eagerly.
"""
from __future__ import annotations

import dataclasses
import sys
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core import engine
from repro_torch.core import strategies as strat_lib
from repro_torch.core.scenario import (AsyncSpec, CommsSpec, DataSpec,
                                       ExecSpec, FleetSpec, Scenario,
                                       TrainSpec)
from repro_torch.kernels import build

__all__ = [
    "Scenario", "DataSpec", "FleetSpec", "TrainSpec", "CommsSpec",
    "AsyncSpec", "ExecSpec", "RunResult", "run",
]


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
    setup_s: float             # host: one-time setup
    compile_s: float           # host: CUDA kernel build at first use
    run_s: float               # host: the rounds + the history fetch
    flushes: Optional[int] = None          # async engines only
    mean_staleness: Optional[float] = None
    peak_device_mem_mb: Optional[float] = None  # CUDA peak allocation
    peak_host_mem_mb: Optional[float] = None    # host peak RSS
    telemetry: Optional[Any] = None             # not ported yet

    def to_history(self) -> Dict[str, Any]:
        """The ``engine.run``-style history dict."""
        return {
            "round": [int(r) for r in self.round],
            "acc": [float(a) for a in self.acc],
            "loss": [float(x) for x in self.loss],
            "time_s": [float(t) for t in self.time_s],
            "energy_j": [float(e) for e in self.energy_j],
            "reclusters": self.reclusters,
            "global_rounds": self.global_rounds,
        }


def _peak_host_mem_mb() -> Optional[float]:
    try:
        import resource
    except ImportError:          # not on every platform
        return None
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    scale = 1.0 if sys.platform == "darwin" else 1024.0
    return round(float(peak) * scale / 1e6, 3)


def run(scenario: Scenario, *, device=None) -> RunResult:
    """Run one scenario end to end on ``device`` (default ``cuda``)."""
    if scenario.exec.mesh_devices is not None:
        raise NotImplementedError(
            "a client mesh is not ported yet (ROADMAP queue 1, slice 12: "
            "core/aggregation_spmd.py, launch/mesh.py)")
    dev = device_lib.resolve(device)
    cfg = scenario.to_flat()
    strategy = strat_lib.get(cfg.method)

    t0 = time.perf_counter()
    if cfg.use_pallas_kernels and dev.type == "cuda":
        build.build_all()
    compile_s = time.perf_counter() - t0

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state0, data = engine.setup(cfg, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    _, outs = engine.simulate(cfg, device=dev, state0=state0, data=data)
    history = engine.history_from_outputs(outs)
    run_s = time.perf_counter() - t0

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
        mesh_shape=None,
        setup_s=round(setup_s, 4), compile_s=round(compile_s, 4),
        run_s=round(run_s, 4),
        peak_device_mem_mb=device_lib.peak_device_mem_mb(dev),
        peak_host_mem_mb=_peak_host_mem_mb(),
    )
