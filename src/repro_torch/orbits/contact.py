"""Precomputed contact plans: time-varying connectivity as device tensors
the round loop indexes by simulated time.

Counterpart of ``repro/orbits/contact.py``.  A :class:`ContactPlan`
samples the constellation over one orbital period (or an explicit
horizon) at a cadence of ~``dt`` and stores, per sample, which satellites
clear the ground station's elevation mask (``gs_visible``), their slant
range to it (``gs_dist_km``) and the all-pairs bounded-hop ISL route cost
in seconds-per-bit (``isl_tpb``, `orbits/topology.route_time_per_bit`).

The plan is built once, eagerly, on the run's device; every lookup after
that is a device-side gather by the simulated clock (no host read), and
wraps modulo the horizon.  Three storage forms, as in the reference:

* the full table, (T, N, N) routes in ``storage_dtype`` (f32, or bf16,
  which keeps ``inf`` and is upcast to f32 at lookup);
* :class:`ClusterContactPlan` (``cluster_slices=(assignment, ps_index)``):
  only each member's route to its own PS, (T, N), and the K PS rows,
  (T, K, N), for a static cluster layout;
* :class:`FactorizedContactPlan`: no routes at all; the same slices are
  recomputed every round from geometry by the K-source relaxation
  (`topology.route_rows_time_per_bit`), O(N * block) memory.

:func:`plan_from_numpy` / :func:`plan_to_numpy` carry a plan's arrays
between packages (a reference plan into the port, and back).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.orbits import topology
from repro_torch.orbits.constellation import (Constellation,
                                              ground_station_position, norm,
                                              visible)
from repro_torch.orbits.links import LinkParams


class ContactPlan(NamedTuple):
    """Sampled connectivity over one horizon."""
    times: torch.Tensor       # (T,) f32 sample times (s); uniform cadence
    gs_visible: torch.Tensor  # (T, N) bool: sat clears the elevation mask
    gs_dist_km: torch.Tensor  # (T, N) f32 slant range sat -> ground station
    isl_tpb: torch.Tensor     # (T, N, N) route s/bit (inf = unreachable),
    #                           f32 or bf16, upcast to f32 by ``lookup``


class ClusterContactPlan(NamedTuple):
    """Cluster-sliced plan: ``tpb_to_ps[t, i]`` is member ``i``'s route to
    its own PS, ``ps_rows[t, k, j]`` cluster ``k``'s PS route to ``j``."""
    times: torch.Tensor       # (T,) f32
    gs_visible: torch.Tensor  # (T, N) bool
    gs_dist_km: torch.Tensor  # (T, N) f32
    tpb_to_ps: torch.Tensor   # (T, N) member -> its PS route s/bit
    ps_rows: torch.Tensor     # (T, K, N) PS -> every sat route s/bit


@dataclass(frozen=True, eq=False)
class FactorizedContactPlan:
    """Storage-free plan: the generator of the sliced plan's rows.  The
    time grid is snapped like the stored plans', so visibility and
    distances equal a stored plan's gathers bit for bit; routes agree to
    float associativity with the same inf/finite pattern.  ``tpb_to_ps``
    comes from the PS rows by the symmetry of the one-hop weights.  Sync
    engine only (:func:`route_to_ps_per_client` raises)."""
    times: torch.Tensor           # (T,) f32 snapped sample grid (s)
    assignment: torch.Tensor      # (N,) int32 static cluster id
    ps_index: torch.Tensor        # (K,) int32 static PS satellites
    constellation: Constellation
    link_params: LinkParams
    gs_lat_deg: float
    gs_lon_deg: float
    min_elevation_deg: float
    max_range_km: float
    max_hops: int
    col_block: int                # routing column-block width (0 = auto)


def _time_grid(constellation: Constellation, dt_s: float,
               horizon_s: Optional[float],
               device: torch.device) -> torch.Tensor:
    """``n`` samples tiling the horizon exactly: the cadence is snapped to
    ``horizon / n`` (so lookups wrap without phase drift), and the grid is
    ``arange(n) * f32(dt)`` in f32, as the reference computes it."""
    horizon = constellation.period_s if horizon_s is None else horizon_s
    n_samples = max(1, int(round(horizon / dt_s)))
    dt = torch.tensor(horizon / n_samples, dtype=torch.float32, device=device)
    return torch.arange(n_samples, dtype=torch.float32, device=device) * dt


def build_factorized_plan(constellation: Constellation,
                          lp: Optional[LinkParams] = None, *,
                          dt_s: float = 60.0,
                          horizon_s: Optional[float] = None,
                          gs_lat_deg: float = 30.0,
                          gs_lon_deg: float = 114.0,
                          min_elevation_deg: float = 10.0,
                          max_range_km: float = 8000.0,
                          max_hops: int = 8,
                          cluster_slices: Optional[Tuple[torch.Tensor,
                                                         torch.Tensor]] = None,
                          col_block: int = 0,
                          device=None) -> FactorizedContactPlan:
    """The factorized counterpart of ``build_contact_plan(...,
    cluster_slices=...)``: the same snapped time grid and no sampling pass
    (building is O(N))."""
    if cluster_slices is None:
        raise ValueError("build_factorized_plan needs cluster_slices="
                         "(assignment, ps_index): the recomputed routes "
                         "are the static cluster layout's slices")
    dev = device_lib.resolve(device)
    assignment, ps_index = cluster_slices
    return FactorizedContactPlan(
        times=_time_grid(constellation, dt_s, horizon_s, dev),
        assignment=torch.as_tensor(assignment, device=dev).to(torch.int32),
        ps_index=torch.as_tensor(ps_index, device=dev).to(torch.int32),
        constellation=constellation, link_params=lp or LinkParams(),
        gs_lat_deg=float(gs_lat_deg), gs_lon_deg=float(gs_lon_deg),
        min_elevation_deg=float(min_elevation_deg),
        max_range_km=float(max_range_km), max_hops=int(max_hops),
        col_block=int(col_block))


def build_contact_plan(constellation: Constellation,
                       lp: Optional[LinkParams] = None, *,
                       dt_s: float = 60.0,
                       horizon_s: Optional[float] = None,
                       gs_lat_deg: float = 30.0, gs_lon_deg: float = 114.0,
                       min_elevation_deg: float = 10.0,
                       max_range_km: float = 8000.0,
                       max_hops: int = 8,
                       storage_dtype: torch.dtype = torch.float32,
                       cluster_slices: Optional[Tuple[torch.Tensor,
                                                      torch.Tensor]] = None,
                       device=None):
    """Sample visibility and ISL routing over ``horizon_s`` (default: one
    orbital period) at a cadence of ~``dt_s`` seconds, on ``device``
    (default ``cuda``).

    Routing is computed in f32 and stored in ``storage_dtype`` (bf16
    halves the (T, N, N) table; ``inf`` survives the cast).  With
    ``cluster_slices=(assignment (N,), ps_index (K,))`` a
    :class:`ClusterContactPlan` is returned instead, sliced per sample so
    the (T, N, N) table never exists; only valid for a static cluster
    layout.  One sample's closure is built at a time, so the build's
    peak is one (N, N) route matrix and one chunk of a (min,+) product
    (`topology.MIN_PLUS_CHUNK_BYTES`) beside the stored table."""
    dev = device_lib.resolve(device)
    lp = lp or LinkParams()
    times = _time_grid(constellation, dt_s, horizon_s, dev)
    t_n, n = times.shape[0], constellation.num_sats
    gs_vis = torch.empty((t_n, n), dtype=torch.bool, device=dev)
    gs_dist = torch.empty((t_n, n), dtype=torch.float32, device=dev)
    if cluster_slices is not None:
        assignment, ps_index = (torch.as_tensor(x, device=dev).long()
                                for x in cluster_slices)
        ps_of_member = ps_index[assignment]                          # (N,)
        members = torch.arange(n, device=dev)
        tpb_to_ps = torch.empty((t_n, n), dtype=storage_dtype, device=dev)
        ps_rows = torch.empty((t_n, ps_index.shape[0], n),
                              dtype=storage_dtype, device=dev)
    else:
        isl_tpb = torch.empty((t_n, n, n), dtype=storage_dtype, device=dev)
    for i in range(t_n):
        t = times[i]
        pos = constellation.positions(t)
        gs = ground_station_position(gs_lat_deg, gs_lon_deg, t_s=t)
        gs_vis[i] = visible(pos, gs, min_elevation_deg)
        gs_dist[i] = norm(pos - gs[None, :])
        tpb = topology.route_time_per_bit(pos, lp, max_range_km, max_hops)
        if cluster_slices is not None:
            tpb_to_ps[i] = tpb[members, ps_of_member]
            ps_rows[i] = tpb[ps_index]
        else:
            isl_tpb[i] = tpb
    if cluster_slices is not None:
        return ClusterContactPlan(times, gs_vis, gs_dist, tpb_to_ps, ps_rows)
    return ContactPlan(times, gs_vis, gs_dist, isl_tpb)


def _sample_index(plan, t: torch.Tensor) -> torch.Tensor:
    """Nearest-sample index, wrapping modulo the horizon; ``t`` is a
    scalar or a per-client vector.  The cadence is ``times[1] - times[0]``
    in f32, as in the reference, and ``round`` rounds half to even in
    both libraries."""
    times = plan.times
    t = torch.as_tensor(t, dtype=torch.float32, device=times.device)
    n = times.shape[0]
    dt = times[1] - times[0] if n > 1 else torch.ones_like(times[0])
    return torch.round(t / dt).long() % n


def _at(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for a tensor index of any rank, without the host read
    that indexing with a 0-d tensor makes."""
    rows = table.index_select(0, idx.reshape(-1))
    return rows.reshape(idx.shape + table.shape[1:])


def lookup(plan: ContactPlan, t_sim
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Nearest-sample connectivity at simulated time ``t_sim``:
    ``(gs_visible (N,), gs_dist_km (N,), isl_tpb (N,N) f32)``."""
    idx = _sample_index(plan, t_sim)
    return (_at(plan.gs_visible, idx), _at(plan.gs_dist_km, idx),
            _at(plan.isl_tpb, idx).float())


def lookup_sliced(plan, t_sim) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor, torch.Tensor]:
    """Scalar-time lookup on a sliced or factorized plan:
    ``(gs_visible (N,), gs_dist_km (N,), tpb_to_ps (N,), ps_rows (K,N))``,
    the gathers the static-layout engine paths consume."""
    if isinstance(plan, FactorizedContactPlan):
        return _lookup_factorized(plan, t_sim)
    idx = _sample_index(plan, t_sim)
    return (_at(plan.gs_visible, idx), _at(plan.gs_dist_km, idx),
            _at(plan.tpb_to_ps, idx).float(), _at(plan.ps_rows, idx).float())


def _lookup_factorized(plan: FactorizedContactPlan, t_sim):
    """The sliced-plan tuple recomputed at the snapped sample time."""
    t = _at(plan.times, _sample_index(plan, t_sim))     # snap, as stored
    pos = plan.constellation.positions(t)
    gs = ground_station_position(plan.gs_lat_deg, plan.gs_lon_deg, t_s=t)
    vis = visible(pos, gs, plan.min_elevation_deg)
    dist = norm(pos - gs[None, :])
    ps_rows = topology.route_rows_time_per_bit(
        pos, plan.ps_index, plan.link_params, plan.max_range_km,
        plan.max_hops, col_block=plan.col_block)
    # member -> own-PS cost by the symmetry of the one-hop weights
    members = torch.arange(pos.shape[0], device=pos.device)
    tpb_to_ps = ps_rows[plan.assignment.long(), members]
    return vis, dist, tpb_to_ps, ps_rows


def route_to_ps_per_client(plan, t_clients: torch.Tensor,
                           ps_of_member: torch.Tensor) -> torch.Tensor:
    """Each member's route s/bit to its PS at its own time:
    ``route(i -> ps_of_member[i]) at t_clients[i]``.  ``ps_of_member`` is
    ignored for a sliced plan, which encodes its layout."""
    if isinstance(plan, FactorizedContactPlan):
        raise NotImplementedError(
            "per-client-clock routing on a FactorizedContactPlan would "
            "recompute the route relaxation once per distinct client "
            "clock; use a stored (full or sliced) plan for the async "
            "engine")
    idx = _sample_index(plan, t_clients)                        # (N,)
    i = torch.arange(idx.shape[0], device=idx.device)
    if isinstance(plan, ClusterContactPlan):
        return plan.tpb_to_ps[idx, i].float()
    return plan.isl_tpb[idx, i, ps_of_member.long()].float()


def contact_windows(plan: ContactPlan, sat: int) -> list:
    """Host-side helper: the ground-station visibility windows of one
    satellite as ``[(t_start_s, t_end_s)]`` half-open intervals over the
    sampled horizon (no wrap-around merging)."""
    vis = plan.gs_visible[:, sat].cpu().numpy()
    times = plan.times.cpu().numpy()
    dt = float(times[1] - times[0]) if times.shape[0] > 1 else 1.0
    windows = []
    start = None
    for i, v in enumerate(vis):
        if v and start is None:
            start = times[i]
        elif not v and start is not None:
            windows.append((float(start), float(times[i])))
            start = None
    if start is not None:
        windows.append((float(start), float(times[-1] + dt)))
    return windows


_KINDS = {cls.__name__: cls for cls in (ContactPlan, ClusterContactPlan,
                                        FactorizedContactPlan)}


def plan_to_numpy(plan) -> Dict[str, Any]:
    """A plan as host values: ``{"kind": class name, field: value}``, tensors
    as numpy (bf16 tables as f32: numpy has no bf16) and, for a factorized
    plan, the constellation and link parameters as field dicts.  The
    inverse of :func:`plan_from_numpy`."""
    if isinstance(plan, FactorizedContactPlan):
        fields = {f.name: getattr(plan, f.name)
                  for f in dataclasses.fields(plan)}
        fields["constellation"] = dataclasses.asdict(plan.constellation)
        fields["link_params"] = dataclasses.asdict(plan.link_params)
    else:
        fields = plan._asdict()
    out = {"kind": type(plan).__name__}
    for name, v in fields.items():
        if isinstance(v, torch.Tensor):
            v = (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy()
        out[name] = v
    return out


def plan_from_numpy(arrays: Dict[str, Any], *, device=None):
    """The plan :func:`plan_to_numpy` describes (or a reference plan's
    arrays in the same layout), on ``device`` (default ``cuda``).  bf16
    arrays (``ml_dtypes``, which ``torch.from_numpy`` refuses) go through a
    16-bit view."""
    dev = device_lib.resolve(device)
    cls = _KINDS[arrays["kind"]]

    def tensor(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a.copy())
        return t.to(dev)

    if cls is FactorizedContactPlan:
        fields = {f.name: arrays[f.name] for f in dataclasses.fields(cls)}
        fields["times"] = tensor(fields["times"])
        for name in ("assignment", "ps_index"):
            fields[name] = tensor(fields[name]).to(torch.int32)
        fields["constellation"] = Constellation(**arrays["constellation"])
        fields["link_params"] = LinkParams(**arrays["link_params"])
        return cls(**fields)
    return cls(*(tensor(arrays[name]) for name in cls._fields))
