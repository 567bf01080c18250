"""Typed, composable experiment specs: the `Scenario` API.

Counterpart of ``repro/core/scenario.py`` in pure Python, with the same
sub-specs, fields, validation, JSON keys, ``canonical_json`` and
``content_hash``, so a manifest written by either package loads in the
other with an equal hash (pinned in ``tests/test_torch_engine.py``).
``exec.use_pallas_kernels`` keeps its name for that reason; in this
package it routes the hot path through the Hopper kernels.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

from repro_torch.core import staleness as stale_lib
from repro_torch.core import strategies as strat_lib
from repro_torch.data.synthetic import MNIST_LIKE, DatasetSpec



def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


# --------------------------------------------------------------------------
# Sub-configs.  Each validates its OWN scalar ranges in __post_init__;
# cross-field constraints (which need the resolved strategy or multiple
# specs at once) live in Scenario.__post_init__.
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class DataSpec:
    """What the clients learn: dataset geometry + non-IID partition."""
    dataset: DatasetSpec = MNIST_LIKE
    samples_per_client: int = 128
    dirichlet_alpha: float = 0.5      # non-IID mixture concentration
    eval_size: int = 1024             # held-out test samples

    def __post_init__(self):
        _require(self.samples_per_client > 0,
                 f"samples_per_client={self.samples_per_client} must be > 0")
        _require(self.dirichlet_alpha > 0,
                 f"dirichlet_alpha={self.dirichlet_alpha} must be > 0")
        _require(self.eval_size > 0,
                 f"eval_size={self.eval_size} must be > 0")

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DataSpec":
        d = dict(d)
        d["dataset"] = DatasetSpec(**d["dataset"])
        return cls(**d)


@dataclass(frozen=True)
class FleetSpec:
    """The constellation: size, cluster layout, re-cluster trigger."""
    num_clients: int = 64             # satellites participating
    num_clusters: int = 4             # K (centralized methods force K=1)
    dropout_threshold: float = 0.5    # Z: re-cluster trigger (Alg. 1)
    round_minutes: float = 1.0        # orbital time advanced per round

    def __post_init__(self):
        _require(self.num_clients >= 1,
                 f"num_clients={self.num_clients} must be >= 1")
        _require(self.num_clusters >= 1,
                 f"num_clusters={self.num_clusters} must be >= 1")
        _require(self.round_minutes >= 0,
                 f"round_minutes={self.round_minutes} must be >= 0")

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FleetSpec":
        return cls(**d)


@dataclass(frozen=True)
class TrainSpec:
    """Optimization schedule: rounds, local SGD, cadence, MAML rates."""
    rounds: int = 150                 # sync: lockstep rounds; async: events
    rounds_per_global: int = 5        # m: stage-1 rounds per stage-2 agg
    local_steps: int = 2              # SGD steps per round (lambda)
    batch_size: int = 64
    lr: float = 0.01
    eval_every: int = 5
    maml_alpha: float = 1e-3          # inner-adaptation rate (Eq. 16)
    maml_beta: float = 1e-3           # meta-update rate (Eq. 17)

    def __post_init__(self):
        _require(self.rounds >= 1, f"rounds={self.rounds} must be >= 1")
        _require(self.rounds_per_global >= 1,
                 f"rounds_per_global={self.rounds_per_global} must be >= 1")
        _require(self.local_steps >= 0,
                 f"local_steps={self.local_steps} must be >= 0")
        _require(self.batch_size >= 1,
                 f"batch_size={self.batch_size} must be >= 1")
        _require(self.eval_every >= 1,
                 f"eval_every={self.eval_every} must be >= 1")

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TrainSpec":
        return cls(**d)


@dataclass(frozen=True)
class CommsSpec:
    """Time-varying connectivity: contact-plan sampling + storage layout.
    Consumed only by visibility-gated strategies; the always-up paper
    methods carry it inertly (and it stays at the defaults)."""
    contact_dt_s: float = 60.0        # contact-plan sample cadence
    gs_min_elevation_deg: float = 10.0
    isl_max_range_km: float = 8000.0  # ISL terminal slant-range limit
    isl_max_hops: int = 8             # route relaxation hop bound
    contact_dtype: str = "float32"    # route-table storage: f32 | bf16
    contact_slices: bool = False      # (T,N)+(T,K,N) member->PS + PS-row
    #                                   slices instead of the full (T,N,N)
    #                                   table; needs a static cluster
    #                                   layout and is per-seed
    contact_factorized: bool = False  # store no routes at all: recompute
    #                                   the slices in-scan from orbital
    #                                   geometry (O(N) plan storage;
    #                                   `orbits/contact.
    #                                   FactorizedContactPlan`).  Same
    #                                   static-layout + per-seed limits as
    #                                   contact_slices; sync-engine only

    def __post_init__(self):
        _require(self.contact_dt_s > 0,
                 f"contact_dt_s={self.contact_dt_s} must be > 0")
        _require(self.isl_max_hops >= 1,
                 f"isl_max_hops={self.isl_max_hops} must be >= 1")
        if self.contact_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"contact_dtype={self.contact_dtype!r} must be 'float32' "
                f"or 'bfloat16' (the ContactPlan storage dtypes)")

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "CommsSpec":
        return cls(**d)


@dataclass(frozen=True)
class AsyncSpec:
    """Event-driven buffered aggregation knobs.  Consumed only by
    ``aggregation="async-buffered"`` strategies; inert otherwise."""
    cohort: int = 0                   # clients popped per event
    #                                   (0 => num_clients: the sync limit)
    buffer: int = 0                   # per-cluster flush threshold
    #                                   (0 => cohort size)
    staleness: str = "polynomial"     # decay schedule (core/staleness.py)
    staleness_a: float = 0.5          # decay exponent / slope
    staleness_b: float = 4.0          # hinge grace window (versions)
    server_lr: float = 1.0            # flush mixing rate (1.0 = replace)

    def __post_init__(self):
        _require(self.cohort >= 0, f"cohort={self.cohort} must be >= 0")
        _require(self.buffer >= 0, f"buffer={self.buffer} must be >= 0")
        if self.staleness not in stale_lib.names():
            raise ValueError(
                f"unknown staleness schedule {self.staleness!r}; "
                f"registered: {stale_lib.names()}")
        _require(0.0 < self.server_lr <= 1.0,
                 f"server_lr={self.server_lr} must be in (0, 1]")

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "AsyncSpec":
        return cls(**d)


@dataclass(frozen=True)
class ExecSpec:
    """How the program executes: client mesh + kernel routing.
    ``mesh_devices=None`` runs on one device; a client mesh (``0`` = every
    rank of the initialized process group, ``n > 0`` = exactly ``n``
    ranks, the world size) shards the client stack one block of rows a
    rank (`launch/mesh.py`, `core/aggregation_spmd.py`)."""
    mesh_devices: Optional[int] = None
    client_axes: Optional[Tuple[str, ...]] = None   # None => every axis
    use_pallas_kernels: bool = False  # route the drift check and every
    #                                   stage-1 through the Hopper
    #                                   kmeans_assign/weighted_agg_multi
    #                                   kernels (the name is the
    #                                   reference's)
    client_microbatch: int = 0        # train clients in blocks of this
    #                                   size (caps activation memory; 0 =
    #                                   all clients at once).  Under a
    #                                   mesh the block must decompose
    #                                   device-locally (cross-field check
    #                                   in Scenario.__post_init__)
    telemetry: bool = False           # per-round device telemetry +
    #                                   host spans (repro_torch.obs),
    #                                   surfaced as RunResult.telemetry

    def __post_init__(self):
        if self.mesh_devices is not None:
            _require(self.mesh_devices >= 0,
                     f"mesh_devices={self.mesh_devices} must be >= 0 "
                     f"(0 = every local device) or None (no mesh)")
        _require(self.client_microbatch >= 0,
                 f"client_microbatch={self.client_microbatch} must be "
                 f">= 0 (0 = full vmap)")
        if self.client_axes is not None and not isinstance(
                self.client_axes, tuple):
            object.__setattr__(self, "client_axes",
                               tuple(self.client_axes))

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ExecSpec":
        d = dict(d)
        if d.get("client_axes") is not None:
            d["client_axes"] = tuple(d["client_axes"])
        return cls(**d)


# --------------------------------------------------------------------------
# Scenario: the composed spec + cross-field validation.
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Scenario:
    """A complete, validated FL experiment spec.

    ``method`` must name a registered strategy
    (`repro_torch.core.strategies.names()`); every cross-field constraint
    is checked here, at construction.  Run with
    :func:`repro_torch.api.run`."""
    method: str = "fedhc"
    seed: int = 0
    data: DataSpec = field(default_factory=DataSpec)
    fleet: FleetSpec = field(default_factory=FleetSpec)
    train: TrainSpec = field(default_factory=TrainSpec)
    comms: CommsSpec = field(default_factory=CommsSpec)
    async_: AsyncSpec = field(default_factory=AsyncSpec)
    exec: ExecSpec = field(default_factory=ExecSpec)

    # ------------------------------------------------------------------
    def __post_init__(self):
        try:
            strategy = strat_lib.get(self.method)
        except KeyError:
            raise ValueError(
                f"unknown FL strategy {self.method!r}; registered: "
                f"{strat_lib.names()}") from None

        if not strategy.centralized:
            _require(
                self.fleet.num_clusters <= self.fleet.num_clients,
                f"num_clusters={self.fleet.num_clusters} exceeds "
                f"num_clients={self.fleet.num_clients}")

        # ---- sliced contact plans need a static cluster layout ----------
        if self.comms.contact_slices and strategy.reclusters:
            raise ValueError(
                f"contact_slices=True is incompatible with the "
                f"re-clustering strategy {self.method!r}: a sliced plan "
                f"only stores routes to the build-time PS set "
                f"(recluster='never' required)")

        # ---- factorized contact plans: static layout, sync-only ---------
        if self.comms.contact_factorized:
            if self.comms.contact_slices:
                raise ValueError(
                    "contact_slices and contact_factorized are mutually "
                    "exclusive contact-plan storage layouts")
            if strategy.reclusters:
                raise ValueError(
                    f"contact_factorized=True is incompatible with the "
                    f"re-clustering strategy {self.method!r}: the "
                    f"factorized plan bakes in the build-time cluster "
                    f"layout (recluster='never' required)")
            if strategy.is_async:
                raise ValueError(
                    f"contact_factorized=True is sync-engine-only "
                    f"({self.method!r} is async): per-client-clock "
                    f"lookups would recompute the route relaxation once "
                    f"per client — use contact_slices for async methods")

        # ---- microbatch must decompose device-locally under a mesh ------
        mb = self.exec.client_microbatch
        md_ = self.exec.mesh_devices
        if (mb and md_ and strategy.shardable
                and mb < self.fleet.num_clients):
            if mb % md_ or (self.fleet.num_clients // md_) % (mb // md_):
                raise ValueError(
                    f"client_microbatch={mb} does not decompose "
                    f"device-locally over mesh_devices={md_}: need "
                    f"microbatch % mesh_devices == 0 and "
                    f"(num_clients//mesh_devices) % "
                    f"(microbatch//mesh_devices) == 0 "
                    f"(num_clients={self.fleet.num_clients})")

        # ---- async cross-checks (engine._statics, moved up front) -------
        if strategy.is_async:
            c = self.fleet.num_clients
            cohort = self.async_.cohort or c
            _require(1 <= cohort <= c,
                     f"async cohort={self.async_.cohort} must be in "
                     f"[1, num_clients={c}] (or 0 for the full-cohort "
                     f"sync limit)")

        # ---- mesh divisibility (launch/mesh semantics, statically) ------
        md = self.exec.mesh_devices
        if md is not None and md > 0 and strategy.shardable:
            if self.fleet.num_clients % md:
                raise ValueError(
                    f"num_clients={self.fleet.num_clients} is not "
                    f"divisible by mesh_devices={md}: the client stack "
                    f"would be padded and mis-sharded "
                    f"(launch/mesh.validate_client_sharding)")

    # ------------------------------------------------------------------
    @property
    def strategy(self) -> strat_lib.Strategy:
        """The resolved strategy entry for ``method``."""
        return strat_lib.get(self.method)

    # ---- flat-config adapter -----------------------------------------
    def to_flat(self) -> "Any":
        """The equivalent flat :class:`repro_torch.core.fedhc.FLRunConfig`
        (the engine's native input).  Inverse of :meth:`from_flat`; the
        mesh placement in :class:`ExecSpec` has no flat-field
        counterpart."""
        from repro_torch.core.fedhc import FLRunConfig
        return FLRunConfig(
            method=self.method, seed=self.seed,
            dataset=self.data.dataset,
            samples_per_client=self.data.samples_per_client,
            dirichlet_alpha=self.data.dirichlet_alpha,
            eval_size=self.data.eval_size,
            num_clients=self.fleet.num_clients,
            num_clusters=self.fleet.num_clusters,
            dropout_threshold=self.fleet.dropout_threshold,
            round_minutes=self.fleet.round_minutes,
            rounds=self.train.rounds,
            rounds_per_global=self.train.rounds_per_global,
            local_steps=self.train.local_steps,
            batch_size=self.train.batch_size,
            lr=self.train.lr,
            eval_every=self.train.eval_every,
            maml_alpha=self.train.maml_alpha,
            maml_beta=self.train.maml_beta,
            contact_dt_s=self.comms.contact_dt_s,
            gs_min_elevation_deg=self.comms.gs_min_elevation_deg,
            isl_max_range_km=self.comms.isl_max_range_km,
            isl_max_hops=self.comms.isl_max_hops,
            contact_dtype=self.comms.contact_dtype,
            contact_slices=self.comms.contact_slices,
            contact_factorized=self.comms.contact_factorized,
            telemetry=self.exec.telemetry,
            client_microbatch=self.exec.client_microbatch,
            async_cohort=self.async_.cohort,
            async_buffer=self.async_.buffer,
            staleness=self.async_.staleness,
            staleness_a=self.async_.staleness_a,
            staleness_b=self.async_.staleness_b,
            server_lr=self.async_.server_lr,
            use_pallas_kernels=self.exec.use_pallas_kernels,
        )

    @classmethod
    def from_flat(cls, cfg, *, mesh_devices: Optional[int] = None,
                  client_axes: Optional[Tuple[str, ...]] = None
                  ) -> "Scenario":
        """Adapter from a flat :class:`repro_torch.core.fedhc.FLRunConfig`.
        Every cross-field constraint is re-checked here, so an invalid
        flat config fails at adapter construction instead of inside an
        engine trace.  ``mesh_devices``/``client_axes`` optionally fill
        the :class:`ExecSpec` (the flat config has no such fields)."""
        return cls(
            method=cfg.method, seed=cfg.seed,
            data=DataSpec(
                dataset=cfg.dataset,
                samples_per_client=cfg.samples_per_client,
                dirichlet_alpha=cfg.dirichlet_alpha,
                eval_size=cfg.eval_size),
            fleet=FleetSpec(
                num_clients=cfg.num_clients,
                num_clusters=cfg.num_clusters,
                dropout_threshold=cfg.dropout_threshold,
                round_minutes=cfg.round_minutes),
            train=TrainSpec(
                rounds=cfg.rounds,
                rounds_per_global=cfg.rounds_per_global,
                local_steps=cfg.local_steps,
                batch_size=cfg.batch_size,
                lr=cfg.lr,
                eval_every=cfg.eval_every,
                maml_alpha=cfg.maml_alpha,
                maml_beta=cfg.maml_beta),
            comms=CommsSpec(
                contact_dt_s=cfg.contact_dt_s,
                gs_min_elevation_deg=cfg.gs_min_elevation_deg,
                isl_max_range_km=cfg.isl_max_range_km,
                isl_max_hops=cfg.isl_max_hops,
                contact_dtype=cfg.contact_dtype,
                contact_slices=cfg.contact_slices,
                contact_factorized=cfg.contact_factorized),
            async_=AsyncSpec(
                cohort=cfg.async_cohort,
                buffer=cfg.async_buffer,
                staleness=cfg.staleness,
                staleness_a=cfg.staleness_a,
                staleness_b=cfg.staleness_b,
                server_lr=cfg.server_lr),
            exec=ExecSpec(
                mesh_devices=mesh_devices,
                client_axes=client_axes,
                use_pallas_kernels=cfg.use_pallas_kernels,
                client_microbatch=cfg.client_microbatch,
                telemetry=cfg.telemetry),
        )

    # ---- JSON round-trip (reproducible benchmark manifests) -----------
    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Scenario":
        return cls(
            method=d["method"], seed=d["seed"],
            data=DataSpec.from_dict(d["data"]),
            fleet=FleetSpec.from_dict(d["fleet"]),
            train=TrainSpec.from_dict(d["train"]),
            comms=CommsSpec.from_dict(d["comms"]),
            async_=AsyncSpec.from_dict(d["async_"]),
            exec=ExecSpec.from_dict(d["exec"]),
        )

    def to_json(self, indent: Optional[int] = 2) -> str:
        """Exact JSON form: ``Scenario.from_json(s.to_json()) == s`` for
        every valid scenario."""
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_json(cls, s: str) -> "Scenario":
        return cls.from_dict(json.loads(s))

    def canonical_json(self) -> str:
        """Deterministic compact JSON (sorted keys, no whitespace): equal
        scenarios produce byte-equal strings, so content addressing is
        stable across processes, field-declaration order and the two
        packages."""
        return json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":"))

    def content_hash(self, n: int = 16) -> str:
        """Hex content hash of :meth:`canonical_json` (first ``n`` chars):
        one scenario <=> one key."""
        return hashlib.sha256(
            self.canonical_json().encode()).hexdigest()[:n]

    # ------------------------------------------------------------------
    def replace(self, **kw) -> "Scenario":
        """`dataclasses.replace` shorthand (re-runs validation)."""
        return dataclasses.replace(self, **kw)
