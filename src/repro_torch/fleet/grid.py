"""`SweepGrid`: a declarative, content-addressed grid of scenarios.

Counterpart of ``repro/fleet/grid.py``: the same schema, expansion, cell
keys and ``grid_hash`` (built on the port's ``Scenario``, whose
``content_hash`` equals the reference's), so one grid file names one
results directory in both packages.

A grid is a **manifest of manifests**: a base :class:`Scenario` (expressed
as dotted-path overrides onto the defaults) plus a list of axes, expanded
by Cartesian product into frozen, validated scenarios — one per cell.
Every cell gets a stable **content-hash key** (`Scenario.content_hash`),
and the grid itself hashes its canonical JSON, so a grid names exactly one
directory of results (`results/sweeps/<grid-hash>/<cell-key>.json`) and a
killed sweep resumes for free (`repro_torch.fleet.store`).

This is the dpgen2 ``Steps``/superop idiom translated to scenario grids:
the grid spec is declarative data, expansion is deterministic, and every
unit of work carries a reproducible key (dflow joins step keys with
``--``; cell step keys here are ``<grid>--<class>--<cell-hash>``, see
`repro_torch.fleet.plan`).

Grid JSON schema (hand-writable; exact round-trip via
:meth:`SweepGrid.from_json` / :meth:`SweepGrid.to_json`)::

    {
      "name": "demo24",
      "base": {"train.rounds": 2, "data.samples_per_client": 16},
      "axes": [
        {"path": "method", "values": ["h-base", "fedce"]},
        {"path": "fleet.num_clients", "values": [8, 12]},
        {"path": "seed", "values": [0, 1, 2, 3, 4, 5]}
      ]
    }

``base`` maps dotted paths into the default scenario dict (dict values
deep-merge, so ``"data.dataset": {...}`` swaps the dataset).  An axis is
either the ``path`` shorthand above (one field, scalar values) or the
general form — named values each setting several paths at once, for
fields that must co-vary (e.g. a dataset with its round budget)::

    {"name": "dataset", "values": [
       {"label": "mnist-like",
        "set": {"data.dataset": {...}, "train.rounds": 100}},
       ...]}
"""
from __future__ import annotations

import hashlib
import itertools
import json
from dataclasses import dataclass
from typing import Any, Dict, List, Sequence, Tuple

from repro_torch.core.scenario import Scenario

__all__ = ["GridAxis", "Cell", "SweepGrid"]


def _set_path(d: Dict[str, Any], path: str, value: Any) -> None:
    """Set ``d["a"]["b"] = value`` for ``path="a.b"``, deep-merging dict
    values so partial sub-dicts override field-by-field."""
    parts = path.split(".")
    for p in parts[:-1]:
        if not isinstance(d.get(p), dict):
            raise KeyError(
                f"grid path {path!r}: {p!r} is not a scenario sub-config "
                f"(known top-level keys: {sorted(d)})")
        d = d[p]
    leaf = parts[-1]
    if leaf not in d:
        raise KeyError(
            f"grid path {path!r}: unknown field {leaf!r} "
            f"(known: {sorted(d)})")
    if isinstance(value, dict) and isinstance(d[leaf], dict):
        for k, v in value.items():
            d[leaf][k] = v
    else:
        d[leaf] = value


@dataclass(frozen=True)
class GridAxis:
    """One sweep axis: named values, each a dict of path overrides."""
    name: str
    labels: Tuple[str, ...]                  # one per value, for cell labels
    values: Tuple[Tuple[Tuple[str, Any], ...], ...]   # per value: ((path,
    #                                          json-value), ...) — tuples,
    #                                          so the axis stays hashable

    def __post_init__(self):
        if len(self.labels) != len(self.values):
            raise ValueError(f"axis {self.name!r}: {len(self.labels)} "
                             f"labels for {len(self.values)} values")
        if not self.values:
            raise ValueError(f"axis {self.name!r} has no values")

    # ---- constructors -------------------------------------------------
    @classmethod
    def single(cls, path: str, values: Sequence[Any],
               name: str = None) -> "GridAxis":
        """The common one-field axis: ``GridAxis.single("method", [...])``."""
        return cls(name or path, tuple(str(v) for v in values),
                   tuple(((path, _freeze(v)),) for v in values))

    @classmethod
    def joint(cls, name: str,
              values: Sequence[Tuple[str, Dict[str, Any]]]) -> "GridAxis":
        """Co-varying fields: values are ``(label, {path: value, ...})``."""
        return cls(name, tuple(lab for lab, _ in values),
                   tuple(tuple(sorted((p, _freeze(v)) for p, v in ov.items()))
                         for _, ov in values))

    # ---- JSON ---------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        if all(len(v) == 1 and v[0][0] == self.name for v in self.values):
            return {"path": self.name,
                    "values": [_thaw(v[0][1]) for v in self.values]}
        return {"name": self.name,
                "values": [{"label": lab,
                            "set": {p: _thaw(v) for p, v in ov}}
                           for lab, ov in zip(self.labels, self.values)]}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "GridAxis":
        if "path" in d:
            return cls.single(d["path"], d["values"])
        return cls.joint(d["name"],
                         [(v["label"], v["set"]) for v in d["values"]])


def _freeze(v: Any) -> Any:
    """JSON value -> hashable form (dicts/lists -> sorted item tuples)."""
    if isinstance(v, dict):
        return ("__dict__",) + tuple(sorted(
            (k, _freeze(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return ("__list__",) + tuple(_freeze(x) for x in v)
    return v


def _thaw(v: Any) -> Any:
    if isinstance(v, tuple) and v and v[0] == "__dict__":
        return {k: _thaw(x) for k, x in v[1:]}
    if isinstance(v, tuple) and v and v[0] == "__list__":
        return [_thaw(x) for x in v[1:]]
    return v


@dataclass(frozen=True)
class Cell:
    """One expanded grid point: a frozen scenario + its stable key."""
    key: str               # Scenario.content_hash (16 hex): the file name
    label: str             # "method=fedhc/N=16/seed=0" — axis name=value
    scenario: Scenario

    @property
    def seed(self) -> int:
        return self.scenario.seed


@dataclass(frozen=True)
class SweepGrid:
    """The typed grid spec; expansion and hashing are deterministic."""
    name: str
    base: Tuple[Tuple[str, Any], ...] = ()   # dotted-path overrides
    axes: Tuple[GridAxis, ...] = ()

    # ---- constructors -------------------------------------------------
    @classmethod
    def build(cls, name: str, base: Dict[str, Any],
              axes: Sequence[GridAxis]) -> "SweepGrid":
        return cls(name, tuple(sorted((p, _freeze(v))
                                      for p, v in base.items())),
                   tuple(axes))

    # ---- expansion ----------------------------------------------------
    def base_scenario_dict(self) -> Dict[str, Any]:
        d = Scenario().to_dict()
        for path, v in self.base:
            _set_path(d, path, _thaw(v))
        return d

    def cells(self) -> List[Cell]:
        """Cartesian-product expansion into validated scenarios.  Every
        cell is constructed through ``Scenario.from_dict``, so invalid
        combinations fail here — at expansion — with the scenario's own
        ValueError, before any run starts."""
        out: List[Cell] = []
        base = self.base_scenario_dict()
        pools = [list(zip(ax.labels, ax.values)) for ax in self.axes]
        for combo in itertools.product(*pools):
            d = json.loads(json.dumps(base))          # deep copy
            for _, overrides in combo:
                for path, v in overrides:
                    _set_path(d, path, _thaw(v))
            sc = Scenario.from_dict(d)
            label = "/".join(f"{ax.name}={lab}" for ax, (lab, _)
                             in zip(self.axes, combo))
            out.append(Cell(sc.content_hash(), label or "base", sc))
        if len({c.key for c in out}) != len(out):
            dupes = [c.label for c in out
                     if sum(1 for o in out if o.key == c.key) > 1]
            raise ValueError(
                f"grid {self.name!r} expands to duplicate scenarios "
                f"(identical cells: {dupes[:6]}...): every cell must be a "
                f"distinct manifest — drop the redundant axis value")
        return out

    # ---- JSON + hashing -----------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name,
                "base": {p: _thaw(v) for p, v in self.base},
                "axes": [ax.to_dict() for ax in self.axes]}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SweepGrid":
        return cls.build(d["name"], d.get("base", {}),
                         [GridAxis.from_dict(a) for a in d.get("axes", [])])

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_json(cls, s: str) -> "SweepGrid":
        return cls.from_dict(json.loads(s))

    @classmethod
    def load(cls, path: str) -> "SweepGrid":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    def grid_hash(self) -> str:
        """12-hex content hash of the canonical grid JSON — the sweep
        directory name: same grid <=> same results directory (resume)."""
        canon = json.dumps(self.to_dict(), sort_keys=True,
                           separators=(",", ":"))
        return hashlib.sha256(canon.encode()).hexdigest()[:12]
