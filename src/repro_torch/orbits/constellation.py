"""LEO Walker-delta constellation (paper §IV-A: 1300 km altitude, 53 deg
inclination, satellites evenly spread per plane, ground station rotating
with Earth).

Counterpart of ``repro/orbits/constellation.py``: ECI positions in km,
float32, with the same expression order so the values round alike.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Union

import torch

R_EARTH_KM = 6371.0
MU_KM3_S2 = 398600.4418          # Earth gravitational parameter
OMEGA_EARTH = 7.2921159e-5       # rad/s

TimeLike = Union[float, torch.Tensor]


@dataclass(frozen=True)
class Constellation:
    num_planes: int = 8
    sats_per_plane: int = 8
    altitude_km: float = 1300.0
    inclination_deg: float = 53.0
    phasing: float = 1.0          # Walker phasing factor

    @property
    def num_sats(self) -> int:
        return self.num_planes * self.sats_per_plane

    @property
    def radius_km(self) -> float:
        return R_EARTH_KM + self.altitude_km

    @property
    def period_s(self) -> float:
        return 2.0 * math.pi * math.sqrt(self.radius_km ** 3 / MU_KM3_S2)

    def positions(self, t_s: TimeLike,
                  device: Optional[torch.device] = None) -> torch.Tensor:
        """Satellite ECI positions at time t (s): (num_sats, 3) km.
        Index layout: sat i = plane * sats_per_plane + slot.  ``t_s`` is a
        Python float or a 0-d float32 tensor (whose device is used)."""
        if isinstance(t_s, torch.Tensor):
            device = t_s.device
        P, S = self.num_planes, self.sats_per_plane
        inc = math.radians(self.inclination_deg)
        plane = torch.arange(P, device=device)
        slot = torch.arange(S, device=device)
        raan = 2.0 * math.pi * plane / P                            # (P,)
        mean_anom = (2.0 * math.pi * slot / S)[None, :] \
            + (2.0 * math.pi * self.phasing * plane / (P * S))[:, None]
        u = mean_anom + 2.0 * math.pi * t_s / self.period_s         # (P,S)

        cu, su = torch.cos(u), torch.sin(u)
        cO, sO = torch.cos(raan)[:, None], torch.sin(raan)[:, None]
        ci, si = math.cos(inc), math.sin(inc)
        x = cu * cO - su * sO * ci
        y = cu * sO + su * cO * ci
        z = su * si
        xyz = torch.stack([x, y, z], dim=-1) * self.radius_km       # (P,S,3)
        return xyz.reshape(P * S, 3)


def ground_station_position(lat_deg: float = 30.0, lon_deg: float = 114.0,
                            t_s: TimeLike = 0.0,
                            device: Optional[torch.device] = None
                            ) -> torch.Tensor:
    """ECI position (3,) of a ground station (rotates with Earth)."""
    if not isinstance(t_s, torch.Tensor):
        t_s = torch.tensor(float(t_s), device=device)
    lat = math.radians(lat_deg)
    lon = math.radians(lon_deg) + OMEGA_EARTH * t_s
    return R_EARTH_KM * torch.stack([
        math.cos(lat) * torch.cos(lon),
        math.cos(lat) * torch.sin(lon),
        torch.full_like(lon, math.sin(lat)),
    ]).reshape(3)
