"""FedHC time and energy accounting (paper §II-C, Eq. 7-10).

Counterpart of ``repro/orbits/cost.py``: the always-up costs over
straight-line links, and the routed costs of the visibility-gated
strategies, whose uploads follow multi-hop ISL routes priced in
seconds-per-bit (`orbits/topology.py`).  A route that does not exist is
``inf``; its cost terms are ``where``'d to 0, never multiplied by a 0/1
mask (``inf * 0`` is NaN).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.orbits.constellation import norm
from repro_torch.orbits.links import LinkParams, comm_time_s, tx_energy_j

Costs = Tuple[torch.Tensor, torch.Tensor]


@dataclass(frozen=True)
class ComputeParams:
    cycles_per_sample: float = 2.0e6      # Q
    min_freq_hz: float = 1.0e8            # f_i range (satellite edge CPUs)
    max_freq_hz: float = 1.0e9
    eps0: float = 1.0e-10                 # epsilon_0 (Eq. 9 coefficient)


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
    d = norm(positions - ps_positions)
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
    return round_of_members(t_i, e_i, participating)


def round_of_members(t_i, e_i, participating) -> Costs:
    """A round from per-member costs: the makespan over participating
    members and their energy sum (what a client mesh computes on the
    gathered (C,) member costs, in this order)."""
    t_round = torch.where(participating, t_i, 0.0).max()
    return t_round, (participating.float() * e_i).sum()


def ground_round_costs(ps_sat_positions, gs_position, model_bits: float,
                       lp: LinkParams) -> Costs:
    """Stage 2 (Eq. 7 outer term): each cluster PS uploads to the ground
    station and receives the global model back."""
    d = norm(ps_sat_positions - gs_position[None, :])
    t = comm_time_s(model_bits, d, lp, to_ground=True)
    e = 2.0 * tx_energy_j(model_bits, d, lp, to_ground=True)
    return t.max(), e.sum()


def routed_cluster_member_costs(tpb_to_ps, reachable, data_sizes, freqs,
                                model_bits: float, lp: LinkParams,
                                cp: ComputeParams) -> Costs:
    """Per-member hop-aware costs: the upload follows the multi-hop ISL
    route to the PS.  A member with no route (``reachable`` False, its
    ``tpb`` inf) uploads nothing and spends only local compute."""
    t_cmp = compute_time_s(data_sizes, freqs, cp)
    t_com = torch.where(reachable, model_bits * tpb_to_ps, 0.0)
    e = (2.0 * lp.tx_power_w * t_com
         + compute_energy_j(data_sizes, freqs, cp))
    return t_cmp + t_com, e


def routed_cluster_round_costs(tpb_to_ps, participating, data_sizes, freqs,
                               model_bits: float, lp: LinkParams,
                               cp: ComputeParams) -> Costs:
    """Hop-aware intra-cluster round: the makespan over participating
    members and the energy sum; every hop retransmits at ``P0`` and the PS
    broadcast back is one more route transmission."""
    t_i, e_i = routed_cluster_member_costs(tpb_to_ps, participating,
                                           data_sizes, freqs, model_bits,
                                           lp, cp)
    return round_of_members(t_i, e_i, participating)


def routed_ground_round_costs(tpb_ps_to_gateway, gateway_gs_dist_km,
                              model_bits: float, lp: LinkParams) -> Costs:
    """Stage 2 via a relay gateway: each of the K PSs routes its model over
    ISLs to the gateway satellite, whose one ground link carries the K
    uploads and the global model back (K + 1 transfers); the ISL legs run
    in parallel (max for time) and each pays up and back route energy."""
    k = tpb_ps_to_gateway.shape[0]
    t_route = model_bits * tpb_ps_to_gateway                      # (K,)
    t_link = comm_time_s(model_bits, gateway_gs_dist_km, lp, to_ground=True)
    t = t_route.max() + (k + 1) * t_link
    e = (2.0 * lp.tx_power_w * t_route).sum() \
        + (k + 1) * tx_energy_j(model_bits, gateway_gs_dist_km, lp,
                                to_ground=True)
    return t, e


def isl_consensus_costs(tpb_ps_pairs, model_bits: float,
                        lp: LinkParams) -> Costs:
    """Ground-station-free stage 2: the K PSs exchange cluster models
    all-to-all over ISL routes (diagonal 0).  Time is the worst pair,
    energy sums every directed transfer."""
    k = tpb_ps_pairs.shape[0]
    off_diag = ~torch.eye(k, dtype=torch.bool, device=tpb_ps_pairs.device)
    t_pair = torch.where(off_diag, model_bits * tpb_ps_pairs, 0.0)
    return t_pair.max(), lp.tx_power_w * t_pair.sum()


def cfedavg_round_costs(positions, server_position, participating,
                        data_sizes, freqs, sample_bits: float,
                        server_freq_hz: float, lp: LinkParams,
                        cp: ComputeParams) -> Costs:
    """C-FedAvg: every client ships its raw data to one satellite server,
    which trains centrally (paper §IV-A)."""
    d = norm(positions - server_position[None, :])
    bits = data_sizes.float() * sample_bits
    t_up = comm_time_s(1.0, d, lp) * bits        # bits / rate_i
    t_train = data_sizes.sum() * cp.cycles_per_sample / server_freq_hz
    t_round = torch.where(participating, t_up, 0.0).max() + t_train
    e_up = lp.tx_power_w * t_up * participating.float()
    e_train = cp.eps0 * server_freq_hz * t_train
    return t_round, e_up.sum() + e_train
