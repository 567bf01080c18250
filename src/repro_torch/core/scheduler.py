"""LEGACY host-side visibility gate (paper §II-A: ground stations see
satellites only inside elevation windows).

Counterpart of ``repro/core/scheduler.py``.  The canonical stage-2 gate
is the contact plan (`orbits/contact.py`), which the engines read on the
device.  :func:`ground_stage_allowed` is the same predicate evaluated on
the host ("is any cluster PS above the elevation mask right now?"), kept
for a launcher that sets ``do_global`` between steps.  Both evaluate
`orbits/constellation.visible` at a float32 time, as
`orbits/contact.build_contact_plan` does, so they agree sample for sample
(``tests/test_torch_support.py``); if you change one, change both.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.orbits.constellation import (Constellation,
                                              ground_station_position,
                                              visible)


@dataclass(frozen=True)
class Schedule:
    rounds_per_global: int = 5      # m: desired ground-station cadence
    min_elevation_deg: float = 10.0


def ground_stage_allowed(constellation: Constellation, t_s, ps_indices,
                         gs_lat: float = 30.0, gs_lon: float = 114.0,
                         min_elevation_deg: float = 10.0, *,
                         device=None) -> torch.Tensor:
    """True (a 0-d bool tensor) iff any cluster PS is visible from the
    ground station at ``t_s`` (a float, or a 0-d tensor whose device is
    used)."""
    t = torch.as_tensor(t_s, dtype=torch.float32, device=device)
    idx = torch.as_tensor(ps_indices, device=t.device).long()
    pos = constellation.positions(t)[idx]
    gs = ground_station_position(gs_lat, gs_lon, t_s=t)
    return visible(pos, gs, min_elevation_deg).any()


def should_aggregate_globally(sch: Schedule, round_idx: int,
                              constellation: Constellation, t_s,
                              ps_indices, *,
                              device=None) -> Tuple[bool, bool]:
    """``(due, fired)``: ``due`` = the cadence says aggregate this round;
    ``fired`` = due and a PS is visible.  When due but not visible the
    launcher defers to the next visible round."""
    due = (round_idx + 1) % sch.rounds_per_global == 0
    if not due:
        return False, False
    vis = bool(ground_stage_allowed(
        constellation, t_s, ps_indices,
        min_elevation_deg=sch.min_elevation_deg, device=device))
    return True, vis
