"""Fleet sweep service: manifest-grid orchestration over `repro_torch.api`.

Counterpart of ``repro/fleet``.  `SweepGrid` (declarative grids of
Scenario manifests, content-hashed cells) -> `plan_grid` (setup and
contact-plan equivalence classes) -> `run_grid` (seed sweeps on one
contact plan and shared-setup loops, resumable `SweepStore` persistence)
-> `SweepStore.query` (time-to-accuracy / cost tables).  CLI:
``python -m repro_torch.fleet.run grid.json``.
"""
from repro_torch.fleet.exec import execute_plan, run_grid
from repro_torch.fleet.grid import Cell, GridAxis, SweepGrid
from repro_torch.fleet.plan import (CompileClass, SweepPlan, compile_key,
                                    equivalent_scenario, plan_grid, setup_key)
from repro_torch.fleet.store import SweepStore

__all__ = [
    "SweepGrid", "GridAxis", "Cell",
    "SweepPlan", "CompileClass", "plan_grid",
    "equivalent_scenario", "compile_key", "setup_key",
    "run_grid", "execute_plan", "SweepStore",
]
