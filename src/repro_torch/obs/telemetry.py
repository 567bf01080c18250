"""Device-plane telemetry: the typed per-round record the engines emit.

Counterpart of ``repro/obs/telemetry.py``.  :class:`Telemetry` is a
NamedTuple of scalars (plus one ``(K,)`` vector) that the sync and async
engines build each round or event from intermediates they already hold:
cohort composition, buffer occupancy, staleness spread, per-stage
simulated traffic, the compute/comm energy split and ISL route hop
counts.  A value the round computes on the device stays a device tensor;
a value the host already holds (the round's Python decisions: the cohort
size, ``did_global``, ``reclustered``) stays a Python number, as the
history's do.  :func:`fetch` stacks the rows into the run's one
device-to-host copy, the one that carries the history, so telemetry adds
no host read.

The invariant (pinned by ``tests/test_torch_obs.py`` and chip_smoke's
``obs`` phase): every telemetry value is a new output derived from
existing intermediates; nothing feeds back into the round state and no
generator is drawn, so the trajectory with telemetry on equals telemetry
off with ``==``, and telemetry off runs the engines' code without it.

:class:`RunTelemetry` is the host-side container surfaced as
``RunResult.telemetry``: the fetched per-round series, the host span
records (`obs/trace.py`) and counter deltas, JSON round-trippable key for
key with the reference's and exportable as Chrome trace-event JSON
(`to_chrome_trace`) for Perfetto.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch


class Telemetry(NamedTuple):
    """Per-round (sync) / per-event (async) device-plane sample.

    Sync-engine semantics in parentheses where the async meaning differs;
    fields an engine cannot measure are 0 (staleness is 0 for synchronous
    rounds, hop counts are 0 for always-up methods)."""
    cohort_size: Any      # () i32 clients that trained this round/event
    accepted: Any         # () i32 updates accepted into aggregation
    #                       (sync: participating members; async: cohort
    #                       members whose upload route existed)
    cluster_fill: Any     # (K,) f32 async: per-cluster buffer occupancy
    #                       after contributions; sync: members per cluster
    stale_min: Any        # () f32 staleness tau of accepted updates
    stale_mean: Any       # () f32 (all 0.0 for sync rounds)
    stale_max: Any        # () f32
    flushes: Any          # () i32 cluster buffer flushes this event
    #                       (sync: K, stage-1 aggregates every round)
    did_global: Any       # () i32 stage-2 aggregation fired
    reclustered: Any      # () i32 re-cluster event fired (sync only)
    bits_stage1: Any      # () f32 simulated intra-cluster traffic (model
    #                       up + broadcast back; c-fedavg: raw-data bits)
    bits_stage2: Any      # () f32 simulated stage-2 traffic (PS<->GS, or
    #                       the all-to-all PS consensus exchange)
    t_round_s: Any        # () f32 simulated duration of this round/event
    e_compute_j: Any      # () f32 local-compute energy this round
    e_comm_j: Any         # () f32 everything else (uplinks, routes,
    #                       stage-2 exchange): e_total - e_compute
    hops_mean: Any        # () f32 mean ISL hops member->PS over reachable
    #                       participants (0.0 for always-up strategies)
    hops_max: Any         # () f32


# the reference's int32 fields; every other field is float32
_INT_FIELDS = frozenset({"cohort_size", "accepted", "flushes", "did_global",
                         "reclustered"})


def fetch(series: torch.Tensor, rows: Sequence[Telemetry]
          ) -> Tuple[np.ndarray, Telemetry]:
    """The run's one device-to-host copy with telemetry on: the history's
    ``(F, R)`` f32 device series and the per-round ``rows`` go to the host
    as one ``(R, F + telemetry columns)`` f32 tensor.  Returns the series
    as numpy ``(F, R)`` and a :class:`Telemetry` of stacked numpy arrays
    (``(R,)``, ``cluster_fill`` ``(R, K)``).  A field is a device tensor in
    every row or in none (the engines decide it per strategy); counts
    carried in f32 are exact below 2**24."""
    r, f = len(rows), series.shape[0]
    on_device = [name for name in Telemetry._fields
                 if isinstance(getattr(rows[0], name), torch.Tensor)]
    cols = [series.T] + [
        torch.stack([getattr(row, name) for row in rows]).float().reshape(
            r, -1) for name in on_device]
    flat = torch.cat(cols, 1).cpu().numpy()               # the one fetch
    out, at = {}, f
    for name, col in zip(on_device, cols[1:]):
        width = col.shape[1]
        v = flat[:, at:at + width]
        out[name] = v if name == "cluster_fill" else v[:, 0]
        at += width
    for name in Telemetry._fields:
        if name not in out:
            out[name] = np.asarray([getattr(row, name) for row in rows])
    return np.ascontiguousarray(flat[:, :f].T), Telemetry(**out)


def rounds_from_scan(telem: Telemetry) -> Dict[str, np.ndarray]:
    """Per-round series keyed by field name, in the reference's dtypes
    (int32 counts, float32 values): scalars become ``(R,)`` arrays,
    ``cluster_fill`` an ``(R, K)`` array.  Takes the engines' stacked
    fields as torch tensors or as numpy already fetched."""
    def host(v):
        return v.cpu().numpy() if isinstance(v, torch.Tensor) else v
    return {name: np.asarray(host(getattr(telem, name)),
                             np.int32 if name in _INT_FIELDS else np.float32)
            for name in Telemetry._fields}


@dataclass
class RunTelemetry:
    """Host-side telemetry record for one run: both planes + counters.

    ``rounds`` is the device plane (`rounds_from_scan`); ``spans`` the
    host plane (`obs.trace.Tracer.span_dicts`: name/ts_us/dur_us/depth);
    ``counters`` the per-run counter deltas."""
    rounds: Dict[str, np.ndarray] = field(default_factory=dict)
    spans: List[Dict[str, Any]] = field(default_factory=list)
    counters: Dict[str, int] = field(default_factory=dict)

    # ---- JSON round-trip (rides RunResult.save/load) -------------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            "rounds": {k: np.asarray(v).tolist()
                       for k, v in self.rounds.items()},
            "spans": self.spans,
            "counters": self.counters,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RunTelemetry":
        return cls(
            rounds={k: np.asarray(v) for k, v in d.get("rounds", {}).items()},
            spans=list(d.get("spans", [])),
            counters=dict(d.get("counters", {})),
        )

    @property
    def num_rounds(self) -> int:
        for v in self.rounds.values():
            return int(np.asarray(v).shape[0])
        return 0

    def phase_times(self) -> Dict[str, float]:
        """Top-level host span name -> total seconds (depth-0 spans)."""
        out: Dict[str, float] = {}
        for s in self.spans:
            if s.get("depth", 0) == 0:
                out[s["name"]] = out.get(s["name"], 0.0) + s["dur_us"] / 1e6
        return out

    def summary(self) -> str:
        """One-line digest for quickstarts and logs."""
        r = self.rounds
        bits = ["telemetry:"]
        if r:
            n = self.num_rounds
            coh = np.asarray(r["cohort_size"], np.float64)
            acc = np.asarray(r["accepted"], np.float64)
            st = np.asarray(r["stale_mean"], np.float64)
            e_c = float(np.sum(r["e_compute_j"]))
            e_m = float(np.sum(r["e_comm_j"]))
            mb = float(np.sum(r["bits_stage1"]) + np.sum(r["bits_stage2"])) / 8e6
            tot = max(e_c + e_m, 1e-12)
            bits.append(
                f"{n} rounds | cohort {coh.mean():.1f} "
                f"(accepted {acc.mean():.1f}) | stale mean {st.mean():.2f} | "
                f"{int(np.sum(r['did_global']))} globals | {mb:.2f} MB | "
                f"energy {100 * e_c / tot:.0f}% compute / "
                f"{100 * e_m / tot:.0f}% comm")
        if self.spans:
            wall = sum(s["dur_us"] for s in self.spans
                       if s.get("depth", 0) == 0) / 1e6
            bits.append(f"| {len(self.spans)} host spans ({wall:.2f}s)")
        return " ".join(bits)

    # ---- Perfetto export ----------------------------------------------
    def to_chrome_trace(self) -> Dict[str, Any]:
        """Chrome trace-event JSON (open in https://ui.perfetto.dev).

        Two tracks: pid 1 = host wall-clock spans (``X`` complete
        events), pid 2 = the simulated timeline: per-round counter
        (``C``) events placed at the *simulated* time of each round, so
        cohort/staleness/energy read as time series against the
        constellation clock."""
        events: List[Dict[str, Any]] = [
            {"name": "process_name", "ph": "M", "pid": 1, "tid": 0,
             "args": {"name": "host (wall clock)"}},
            {"name": "process_name", "ph": "M", "pid": 2, "tid": 0,
             "args": {"name": "simulated constellation clock"}},
        ]
        for s in self.spans:
            events.append({"name": s["name"], "ph": "X", "pid": 1,
                           "tid": 1, "ts": s["ts_us"], "dur": s["dur_us"],
                           "args": s.get("args", {})})
        if self.counters:
            events.append({"name": "cache_counters", "ph": "I", "pid": 1,
                           "tid": 1, "ts": 0.0, "s": "g",
                           "args": {k: int(v)
                                    for k, v in self.counters.items()}})
        r = self.rounds
        if r:
            t = np.cumsum(np.asarray(r["t_round_s"], np.float64))
            series = {
                "cohort": ("cohort_size", "accepted"),
                "staleness": ("stale_mean", "stale_max"),
                "energy_j": ("e_compute_j", "e_comm_j"),
                "traffic_bits": ("bits_stage1", "bits_stage2"),
                "hops": ("hops_mean", "hops_max"),
            }
            for name, keys in series.items():
                for i, ts in enumerate(t):
                    events.append({
                        "name": name, "ph": "C", "pid": 2, "tid": 0,
                        "ts": float(ts) * 1e6,
                        "args": {k: float(np.asarray(r[k])[i])
                                 for k in keys}})
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def save_chrome_trace(self, path: str) -> None:
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)


def load_chrome_trace(path: str) -> Dict[str, Any]:
    """Parse-and-validate helper (the smokes and the tests use it)."""
    with open(path) as f:
        d = json.load(f)
    evs = d.get("traceEvents")
    if not isinstance(evs, list) or not evs:
        raise ValueError(f"{path}: no traceEvents, not a Chrome trace")
    for e in evs:
        if "ph" not in e or "pid" not in e:
            raise ValueError(f"{path}: malformed trace event {e!r}")
    return d
