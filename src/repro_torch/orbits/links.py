"""Satellite link model (paper Eq. 6): r_i = B ln(1 + P0 h_i / N0), with
free-space gain h = g0 / d^2 (d in km).  Counterpart of
``repro/orbits/links.py``.

A Python number divided by a tensor is written ``full_like(t, n) / t``:
``n / t`` in PyTorch is ``t.reciprocal() * n``, which rounds twice.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class LinkParams:
    bandwidth_hz: float = 1.0e6       # B_i
    tx_power_w: float = 0.5           # P_0
    noise_w: float = 1.0e-10          # N_0
    gain_km2: float = 4.0e-4          # g0: h_i = g0 / d_km^2
    # ground-station links get a bigger dish => higher effective gain
    gs_gain_boost: float = 4.0


def _rdiv(num: float, den: torch.Tensor) -> torch.Tensor:
    return torch.full_like(den, num) / den


def channel_gain(dist_km: torch.Tensor, p: LinkParams,
                 to_ground: bool = False) -> torch.Tensor:
    g = _rdiv(p.gain_km2, dist_km.clamp_min(1.0) ** 2)
    return g * (p.gs_gain_boost if to_ground else 1.0)


def rate_bps(dist_km: torch.Tensor, p: LinkParams,
             to_ground: bool = False) -> torch.Tensor:
    """Eq. 6 (natural log, as printed in the paper)."""
    h = channel_gain(dist_km, p, to_ground)
    return p.bandwidth_hz * torch.log(1.0 + p.tx_power_w * h / p.noise_w)


def comm_time_s(bits: float, dist_km: torch.Tensor, p: LinkParams,
                to_ground: bool = False) -> torch.Tensor:
    """t_com = zeta / r_i."""
    return _rdiv(bits, rate_bps(dist_km, p, to_ground).clamp_min(1.0))


def time_per_bit(dist_km: torch.Tensor, p: LinkParams,
                 to_ground: bool = False) -> torch.Tensor:
    """Seconds per bit over one hop (1 / r_i): the edge weight the ISL
    router (`orbits/topology.py`) minimizes over multi-hop routes."""
    return _rdiv(1.0, rate_bps(dist_km, p, to_ground).clamp_min(1.0))


def tx_energy_j(bits: float, dist_km: torch.Tensor, p: LinkParams,
                to_ground: bool = False) -> torch.Tensor:
    """Eq. 8 summand: P0 * |w| / r_i."""
    return p.tx_power_w * comm_time_s(bits, dist_km, p, to_ground)
