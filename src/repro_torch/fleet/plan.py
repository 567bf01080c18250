"""Sweep planner: partition grid cells into equivalence classes.

Counterpart of ``repro/fleet/plan.py``, with the reference's class
partition, keys and mode names, so one grid gives the same classes in
both packages.  What a class shares differs: the reference compiles one
scan program per class, while eager PyTorch has nothing to compile, so
in the port a class is the unit of **setup and contact-plan sharing**.
Three relations between cells:

* **execution equivalence**: two cells whose scenarios differ only in
  knobs their strategy never reads run identical trajectories, so one
  run serves both.  :func:`equivalent_scenario` normalizes the inert
  knobs away (per resolved `Strategy` flags): a centralized method
  ignores ``num_clusters`` (the engine forces K=1, so c-fedavg's K
  columns collapse into one run), a non-re-clustering method ignores
  ``dropout_threshold`` and the MAML rates, a non-visibility-gated method
  carries :class:`CommsSpec` inertly, a sync method never reads
  :class:`AsyncSpec`.  Trajectory preservation is pinned in
  ``tests/test_torch_fleet.py``.
* **class equivalence** (the reference's compile key): cells whose
  execution-equivalent scenarios differ only in ``seed`` form one
  :class:`CompileClass`.  A ``vmap`` class runs as one
  ``api.run_sweep`` over its seeds, a loop over seeds on one contact
  plan (``engine.run_many_seeds``: one plan build for a gated class,
  counted as ``engine.plan_cache.miss`` in ``obs.trace.COUNTERS``); a
  ``loop`` class runs ``api.run`` per job with one shared
  ``setup_cache``.
* **setup equivalence**: setup (data, model init, clustering, contact
  plan) does not read the execution-only knobs (``client_microbatch`` /
  ``use_pallas_kernels`` / ``telemetry``), the invariant behind
  ``api._setup_cache_key``.  Cells differing only in those share one
  cached setup (``api.setup_cache.hit``).

Class step keys follow the dflow/dpgen2 convention of ``--``-joined
hierarchical keys: ``<grid-name>--cls-<idx>--<class-key>``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List

from repro_torch.core.scenario import AsyncSpec, CommsSpec, Scenario, TrainSpec
from repro_torch.fleet.grid import Cell, SweepGrid

__all__ = ["equivalent_scenario", "compile_key", "setup_key",
           "CompileClass", "SweepPlan", "plan_grid"]


def equivalent_scenario(sc: Scenario) -> Scenario:
    """The execution-equivalent canonical form of ``sc``: every knob the
    resolved strategy never reads is reset to its default.  The returned
    scenario runs an identical trajectory (same setup streams, same
    rounds, same data); each normalization is a field the engines read
    only behind a `Strategy` flag."""
    s = sc.strategy
    fleet, train = sc.fleet, sc.train
    if s.centralized and fleet.num_clusters != 1:
        # engine.setup / simulate force k=1 for centralized methods
        fleet = dataclasses.replace(fleet, num_clusters=1)
    if not s.reclusters:
        # cfg.dropout_threshold is only read inside the re-cluster branch
        fleet = dataclasses.replace(
            fleet, dropout_threshold=Scenario().fleet.dropout_threshold)
    if not (s.reclusters and s.maml):
        # MAML rates are only read in the re-cluster inheritance branch
        d = TrainSpec()
        train = dataclasses.replace(train, maml_alpha=d.maml_alpha,
                                    maml_beta=d.maml_beta)
    comms = sc.comms if s.visibility_gated else CommsSpec()
    async_ = sc.async_ if s.is_async else AsyncSpec()
    return dataclasses.replace(sc, fleet=fleet, train=train, comms=comms,
                               async_=async_)


def compile_key(sc: Scenario) -> str:
    """Class key (the reference's compile-cache key, kept so both
    packages partition a grid alike): the execution-equivalent scenario
    with the seed normalized away."""
    return equivalent_scenario(sc).replace(seed=0).content_hash()


def setup_key(sc: Scenario) -> str:
    """Setup-cache equivalence key: exec-only knobs normalized (mirrors
    ``api._setup_cache_key``), seed KEPT: setup consumes the seed."""
    eq = equivalent_scenario(sc)
    ex = dataclasses.replace(eq.exec, client_microbatch=0,
                             use_pallas_kernels=False, telemetry=False)
    return dataclasses.replace(eq, exec=ex).content_hash()


def _batchable(sc: Scenario) -> bool:
    """Can this cell ride a seed sweep (``api.run_sweep``)?  Its limits:
    sync single-device runs on a seed-shareable contact plan; telemetry
    is excluded because the sweep drops the device plane (a cell that
    records telemetry runs ``api.run``)."""
    s = sc.strategy
    return (not s.is_async
            and sc.exec.mesh_devices is None
            and not sc.comms.contact_slices
            and not sc.comms.contact_factorized
            and not sc.exec.telemetry)


@dataclass
class CompileClass:
    """One equivalence class: cells that share a setup path (the
    reference's compile class).  ``jobs`` are the distinct
    execution-equivalent scenarios (cells beyond their job's first are
    duplicates: run once, fan the result out); within a class jobs differ
    ONLY in seed."""
    key: str                          # compile_key of every member
    step_key: str                     # "<grid>--cls-<idx>--<key>"
    mode: str                         # "vmap" | "loop"
    cells: List[Cell]
    jobs: Dict[str, Scenario]         # exec-equivalent hash -> scenario
    cell_jobs: Dict[str, str]         # cell key -> job hash

    @property
    def seeds(self) -> List[int]:
        return [job.seed for job in self.jobs.values()]

    def to_dict(self) -> Dict[str, Any]:
        return {"key": self.key, "step_key": self.step_key,
                "mode": self.mode,
                "cells": [{"key": c.key, "label": c.label,
                           "job": self.cell_jobs[c.key]}
                          for c in self.cells],
                "jobs": {h: sc.to_dict() for h, sc in self.jobs.items()}}


@dataclass
class SweepPlan:
    """The full declarative execution plan for one grid."""
    grid: SweepGrid
    cells: List[Cell]
    classes: List[CompileClass]
    setup_classes: Dict[str, List[str]] = field(default_factory=dict)
    #   setup_key -> cell keys sharing one setup

    @property
    def num_compiles(self) -> int:
        """Classes (the reference's lower+compile count; here the units
        of setup and plan sharing)."""
        return len(self.classes)

    def to_dict(self) -> Dict[str, Any]:
        return {"grid_name": self.grid.name,
                "grid_hash": self.grid.grid_hash(),
                "num_cells": len(self.cells),
                "num_classes": len(self.classes),
                "num_setup_classes": len(self.setup_classes),
                "classes": [c.to_dict() for c in self.classes],
                "setup_classes": self.setup_classes}

    def summary(self) -> str:
        njobs = sum(len(c.jobs) for c in self.classes)
        lines = [
            f"plan: {len(self.cells)} cells -> {njobs} runs "
            f"({len(self.cells) - njobs} deduped) in "
            f"{len(self.classes)} classes / "
            f"{len(self.setup_classes)} setup classes"]
        for c in self.classes:
            first = c.cells[0]
            lines.append(
                f"  [{c.mode:4s}] {c.step_key}: {len(c.cells)} cells, "
                f"{len(c.jobs)} runs  (e.g. {first.label})")
        return "\n".join(lines)


def plan_grid(grid: SweepGrid) -> SweepPlan:
    """Expand the grid and partition cells into classes (stable order:
    first-cell-seen per class, cells in expansion order)."""
    cells = grid.cells()
    by_class: Dict[str, List[Cell]] = {}
    for c in cells:
        by_class.setdefault(compile_key(c.scenario), []).append(c)

    classes: List[CompileClass] = []
    for idx, (ckey, members) in enumerate(by_class.items()):
        jobs: Dict[str, Scenario] = {}
        cell_jobs: Dict[str, str] = {}
        for c in members:
            eq = equivalent_scenario(c.scenario)
            jh = eq.content_hash()
            jobs.setdefault(jh, eq)
            cell_jobs[c.key] = jh
        mode = ("vmap" if len(jobs) > 1
                and _batchable(next(iter(jobs.values()))) else "loop")
        classes.append(CompileClass(
            key=ckey, step_key=f"{grid.name}--cls-{idx:03d}--{ckey}",
            mode=mode, cells=members, jobs=jobs, cell_jobs=cell_jobs))

    setup_classes: Dict[str, List[str]] = {}
    for c in cells:
        setup_classes.setdefault(setup_key(c.scenario), []).append(c.key)
    return SweepPlan(grid=grid, cells=cells, classes=classes,
                     setup_classes=setup_classes)
