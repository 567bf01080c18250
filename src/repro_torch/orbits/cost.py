"""FedHC time and energy accounting for always-up links (paper §II-C,
Eq. 7-10).  Counterpart of the always-up half of ``repro/orbits/cost.py``;
the routed (contact-plan) costs come with the connectivity slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.orbits.links import LinkParams, comm_time_s, tx_energy_j

Costs = Tuple[torch.Tensor, torch.Tensor]


@dataclass(frozen=True)
class ComputeParams:
    cycles_per_sample: float = 2.0e6      # Q
    min_freq_hz: float = 1.0e8            # f_i range (satellite edge CPUs)
    max_freq_hz: float = 1.0e9
    eps0: float = 1.0e-10                 # epsilon_0 (Eq. 9 coefficient)


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((x * x).sum(-1))


def sample_freqs(gen: torch.Generator, n: int,
                 p: ComputeParams) -> torch.Tensor:
    u = torch.rand((n,), generator=gen, device=gen.device)
    return p.min_freq_hz + u * (p.max_freq_hz - p.min_freq_hz)


def compute_time_s(data_sizes, freqs, p: ComputeParams) -> torch.Tensor:
    """t_cmp_i = D_i * Q / f_i."""
    return data_sizes.float() * p.cycles_per_sample / freqs


def compute_energy_j(data_sizes, freqs, p: ComputeParams) -> torch.Tensor:
    """Eq. 9 summand: eps0 * f_i * t_cmp_i."""
    return p.eps0 * freqs * compute_time_s(data_sizes, freqs, p)


def cluster_member_costs(positions, ps_positions, data_sizes, freqs,
                         model_bits: float, lp: LinkParams,
                         cp: ComputeParams) -> Costs:
    """Per-member ``t_i = t_cmp + t_com`` and ``e_i`` = 2 model
    transmissions (Eq. 8, upload + PS broadcast) + compute (Eq. 9)."""
    d = _norm(positions - ps_positions)
    t_cmp = compute_time_s(data_sizes, freqs, cp)
    t_com = comm_time_s(model_bits, d, lp)
    e = (2.0 * tx_energy_j(model_bits, d, lp)
         + compute_energy_j(data_sizes, freqs, cp))
    return t_cmp + t_com, e


def cluster_round_costs(positions, ps_positions, assignment, participating,
                        data_sizes, freqs, model_bits: float,
                        lp: LinkParams, cp: ComputeParams) -> Costs:
    """One intra-cluster round (Eq. 7 inner max + Eq. 8/9): the makespan
    over participating members and the energy sum."""
    t_i, e_i = cluster_member_costs(positions, ps_positions, data_sizes,
                                    freqs, model_bits, lp, cp)
    t_round = torch.where(participating, t_i, 0.0).max()
    return t_round, (participating.float() * e_i).sum()


def ground_round_costs(ps_sat_positions, gs_position, model_bits: float,
                       lp: LinkParams) -> Costs:
    """Stage 2 (Eq. 7 outer term): each cluster PS uploads to the ground
    station and receives the global model back."""
    d = _norm(ps_sat_positions - gs_position[None, :])
    t = comm_time_s(model_bits, d, lp, to_ground=True)
    e = 2.0 * tx_energy_j(model_bits, d, lp, to_ground=True)
    return t.max(), e.sum()


def cfedavg_round_costs(positions, server_position, participating,
                        data_sizes, freqs, sample_bits: float,
                        server_freq_hz: float, lp: LinkParams,
                        cp: ComputeParams) -> Costs:
    """C-FedAvg: every client ships its raw data to one satellite server,
    which trains centrally (paper §IV-A)."""
    d = _norm(positions - server_position[None, :])
    bits = data_sizes.float() * sample_bits
    t_up = comm_time_s(1.0, d, lp) * bits        # bits / rate_i
    t_train = data_sizes.sum() * cp.cycles_per_sample / server_freq_hz
    t_round = torch.where(participating, t_up, 0.0).max() + t_train
    e_up = lp.tx_power_w * t_up * participating.float()
    e_train = cp.eps0 * server_freq_hz * t_train
    return t_round, e_up.sum() + e_train
