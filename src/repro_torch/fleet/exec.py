"""Sweep executor: run a planned grid with setup sharing and resume.

Counterpart of ``repro/fleet/exec.py``.  Per
:class:`~repro_torch.fleet.plan.CompileClass`:

* ``vmap`` classes (sync, single-device, shareable contact plan,
  telemetry off) run ALL pending cells as **one seed sweep**:
  ``api.run_sweep`` over the class's seed list on the seed-normalized
  equivalent scenario (``engine.run_many_seeds``: one contact plan for
  the class, a loop over seeds).  The reference runs one vmapped
  executable there.
* ``loop`` classes (async / sliced / factorized / telemetry-recording
  cells) run ``api.run`` per distinct job, with one shared
  ``setup_cache`` dict that reuses setup across cells that differ only
  in exec knobs (the setup equivalence classes).

Cells whose execution-equivalent scenarios coincide (e.g. c-fedavg across
K columns) run ONCE; the result fans out to every duplicate cell, each
saved under its own key with its own manifest embedded.

Every completed cell is a ``RunResult`` JSON in the grid's store
directory; on re-entry completed keys are skipped
(``fleet.cells.skipped`` in :data:`~repro_torch.obs.trace.COUNTERS`), so
a killed sweep resumes for free and a finished sweep re-runs as a no-op.
The per-class report records what the class shared: setup-cache hits and
misses (``api.setup_cache.*``) and contact-plan builds and reuses
(``engine.plan_cache.*``), in place of the reference's compile counters,
which eager PyTorch has no counterpart of.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Tuple

import numpy as np

from repro_torch.fleet.grid import SweepGrid
from repro_torch.fleet.plan import CompileClass, SweepPlan, plan_grid
from repro_torch.fleet.store import SweepStore
from repro_torch.obs.trace import COUNTERS, Counters

__all__ = ["run_grid", "execute_plan"]

# counter keys the per-class report records (setup and plan sharing)
_TRACKED = ("api.setup_cache.hit", "api.setup_cache.miss",
            "engine.plan_cache.hit", "engine.plan_cache.miss")


def _result_from_sweep_row(sweep, i: int, scenario, strategy,
                           run_s: float):
    """Per-cell RunResult from row ``i`` of a class SweepResult.  Timing
    semantics: the sweep's wall is amortized uniformly over its cells as
    ``run_s`` (setup is folded in: the sweep does not split phases)."""
    from repro_torch.api import RunResult
    ev = np.asarray(sweep.evaluated[i], bool)
    idx = np.nonzero(ev)[0]
    return RunResult(
        scenario=scenario,
        round=np.asarray(idx + 1, np.int64),
        acc=np.asarray(sweep.acc[i, idx], np.float64),
        loss=np.asarray(sweep.loss[i, idx], np.float64),
        time_s=np.asarray(sweep.time_s[i, idx], np.float64),
        energy_j=np.asarray(sweep.energy_j[i, idx], np.float64),
        reclusters=int(sweep.reclusters[i]),
        global_rounds=int(sweep.global_rounds[i]),
        strategy=dataclasses.asdict(strategy),
        mesh_shape=None,
        setup_s=0.0, compile_s=0.0, run_s=round(run_s, 4))


def _run_class_vmap(cls: CompileClass, pending, store: SweepStore,
                    device, log) -> None:
    """One seed sweep over the class's pending seeds (one contact plan)."""
    from repro_torch import api
    jobs = [(jh, cls.jobs[jh]) for jh in
            sorted({cls.cell_jobs[c.key] for c in pending},
                   key=lambda h: cls.jobs[h].seed)]
    seeds = [sc.seed for _, sc in jobs]
    sweep = api.run_sweep(jobs[0][1].replace(seed=0), seeds, device=device)
    row_of = {jh: i for i, (jh, _) in enumerate(jobs)}
    per_cell = sweep.wall_s / max(len(pending), 1)
    strategy = jobs[0][1].strategy
    for c in pending:
        res = _result_from_sweep_row(sweep, row_of[cls.cell_jobs[c.key]],
                                     c.scenario, strategy, per_cell)
        store.save_cell(c.key, res)
        COUNTERS.inc("fleet.cells.run")
    COUNTERS.inc("fleet.cells.deduped", len(pending) - len(jobs))
    log(f"  [vmap] {cls.step_key}: {len(jobs)} seeds in one sweep "
        f"-> {len(pending)} cells ({sweep.wall_s:.1f}s)")


def _run_class_loop(cls: CompileClass, pending, store: SweepStore,
                    setup_cache: Dict[Any, Any], device, log) -> None:
    """One api.run per distinct job; the shared setup_cache dedupes setup
    across exec-only variants."""
    from repro_torch import api
    results: Dict[str, Any] = {}
    for c in pending:
        jh = cls.cell_jobs[c.key]
        if jh not in results:
            t0 = time.perf_counter()
            results[jh] = api.run(cls.jobs[jh], setup_cache=setup_cache,
                                  device=device)
            log(f"  [loop] {cls.step_key}: {c.label} "
                f"({time.perf_counter() - t0:.1f}s)")
        else:
            COUNTERS.inc("fleet.cells.deduped")
        # embed the cell's OWN manifest, not the normalized equivalent
        store.save_cell(c.key, dataclasses.replace(
            results[jh], scenario=c.scenario))
        COUNTERS.inc("fleet.cells.run")


def execute_plan(plan: SweepPlan, store: SweepStore, *, device=None,
                 verbose: bool = True) -> Dict[str, Any]:
    """Execute every pending cell of ``plan`` into ``store`` on ``device``
    (default ``cuda``); returns the report dict (also persisted as
    ``report.json``)."""
    log = print if verbose else (lambda *_: None)
    store.write_plan(plan.to_dict())
    done = store.completed()
    setup_cache: Dict[Any, Any] = {}
    classes_report: List[Dict[str, Any]] = []
    t_all = time.perf_counter()
    for cls in plan.classes:
        pending = [c for c in cls.cells if c.key not in done]
        skipped = len(cls.cells) - len(pending)
        if skipped:
            COUNTERS.inc("fleet.cells.skipped", skipped)
        entry: Dict[str, Any] = {
            "step_key": cls.step_key, "mode": cls.mode,
            "cells": len(cls.cells), "skipped": skipped,
            "run": len(pending), "label": cls.cells[0].label,
        }
        if pending:
            c0 = COUNTERS.snapshot()
            t0 = time.perf_counter()
            if cls.mode == "vmap":
                COUNTERS.inc("fleet.class.vmap")
                _run_class_vmap(cls, pending, store, device, log)
            else:
                COUNTERS.inc("fleet.class.loop")
                _run_class_loop(cls, pending, store, setup_cache, device,
                                log)
            wall = time.perf_counter() - t0
            delta = Counters.delta(c0, COUNTERS.snapshot())
            rounds = sum(c.scenario.train.rounds for c in pending)
            entry.update(
                wall_s=round(wall, 4),
                per_round_s=round(wall / max(rounds, 1), 6),
                counters={k: v for k, v in delta.items()
                          if k in _TRACKED})
        classes_report.append(entry)
    report = {
        "grid_name": plan.grid.name,
        "grid_hash": plan.grid.grid_hash(),
        "num_cells": len(plan.cells),
        "num_classes": len(plan.classes),
        "num_setup_classes": len(plan.setup_classes),
        "cells_run": sum(e.get("run", 0) for e in classes_report),
        "cells_skipped": sum(e["skipped"] for e in classes_report),
        "wall_s": round(time.perf_counter() - t_all, 4),
        "classes": classes_report,
    }
    store.write_report(report)
    return report


def run_grid(grid: SweepGrid, base_dir: str = "results/sweeps", *,
             device=None, verbose: bool = True
             ) -> Tuple[SweepStore, Dict[str, Any]]:
    """Plan + execute a grid (resuming any completed cells) and return
    ``(store, report)``: the one-call fleet entry point."""
    plan = plan_grid(grid)
    store = SweepStore.open(base_dir, grid)
    if verbose:
        print(f"[fleet] grid {grid.name!r} -> {store.root}")
        print(plan.summary())
    report = execute_plan(plan, store, device=device, verbose=verbose)
    if verbose:
        print(f"[fleet] {report['cells_run']} run / "
              f"{report['cells_skipped']} skipped / "
              f"{report['num_classes']} classes / "
              f"{report['wall_s']:.1f}s")
    return store, report
