"""Resumable on-disk sweep store + time-to-accuracy query layer.

Counterpart of ``repro/fleet/store.py``, in the same directory layout and
file format: the reference's ``SweepStore.query`` reads cells the port
wrote and this one reads the reference's (a cell is a ``RunResult`` JSON,
the same in both packages).

Layout (``results/sweeps/<grid-hash>/``)::

    grid.json         the SweepGrid manifest (verified on open: a hash
                      collision or edited grid fails loudly)
    plan.json         the expansion/equivalence-class plan (fleet/plan.py)
    report.json       post-execution: per-class wall / cache counters
    <cell-key>.json   one RunResult per completed cell, embedded manifest

A cell file is a plain ``RunResult.save`` artifact — loadable by
``python -m repro_torch.obs.report`` like any other run — whose embedded
scenario is the cell's OWN manifest (even when the executor ran a
deduplicated or normalized equivalent).  Resume is file-existence: re-run
a grid and every completed key is skipped, so a killed sweep costs only
the unfinished cells.

:meth:`SweepStore.query` is the serving story: group completed cells over
the seed axis, average the eval curves, and answer
``time/energy-to-accuracy`` per grid point — the FedHC Table-I shape —
without re-running anything.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence, Set

import numpy as np

from repro_torch.fleet.grid import SweepGrid

__all__ = ["SweepStore"]

_META_FILES = ("grid.json", "plan.json", "report.json")


class SweepStore:
    """Per-grid results directory; one JSON file per completed cell."""

    def __init__(self, root: str) -> None:
        self.root = root

    # ---- lifecycle ----------------------------------------------------
    @classmethod
    def open(cls, base_dir: str, grid: SweepGrid) -> "SweepStore":
        """Create (or re-open) the grid's directory under ``base_dir``.
        An existing ``grid.json`` must match the grid exactly — resuming
        into another grid's directory is an error, not silent reuse."""
        root = os.path.join(base_dir, grid.grid_hash())
        os.makedirs(root, exist_ok=True)
        gpath = os.path.join(root, "grid.json")
        if os.path.exists(gpath):
            with open(gpath) as f:
                existing = json.load(f)
            if existing != grid.to_dict():
                raise ValueError(
                    f"{gpath} holds a different grid manifest than "
                    f"{grid.name!r} (hash collision or edited file) — "
                    f"remove the directory to rebuild it")
        else:
            with open(gpath, "w") as f:
                json.dump(grid.to_dict(), f, indent=2)
        return cls(root)

    @classmethod
    def open_dir(cls, root: str) -> "SweepStore":
        """Open an existing sweep directory (must hold a grid.json)."""
        if not os.path.exists(os.path.join(root, "grid.json")):
            raise FileNotFoundError(
                f"{root} is not a sweep directory (no grid.json)")
        return cls(root)

    def grid(self) -> SweepGrid:
        with open(os.path.join(self.root, "grid.json")) as f:
            return SweepGrid.from_dict(json.load(f))

    # ---- cells --------------------------------------------------------
    def cell_path(self, key: str) -> str:
        return os.path.join(self.root, f"{key}.json")

    def has(self, key: str) -> bool:
        return os.path.exists(self.cell_path(key))

    def completed(self) -> Set[str]:
        """Keys of every completed cell (resume = skip these)."""
        return {f[:-5] for f in os.listdir(self.root)
                if f.endswith(".json") and f not in _META_FILES}

    def save_cell(self, key: str, result) -> None:
        """Atomic write: a killed sweep never leaves a truncated cell
        (resume trusts file existence)."""
        tmp = self.cell_path(key) + ".tmp"
        result.save(tmp)
        os.replace(tmp, self.cell_path(key))

    def load_cell(self, key: str):
        from repro_torch.api import RunResult
        return RunResult.load(self.cell_path(key))

    def load_all(self) -> Dict[str, Any]:
        return {k: self.load_cell(k) for k in sorted(self.completed())}

    # ---- plan / report sidecars ---------------------------------------
    def write_plan(self, plan_dict: Dict[str, Any]) -> None:
        with open(os.path.join(self.root, "plan.json"), "w") as f:
            json.dump(plan_dict, f, indent=2)

    def read_plan(self) -> Optional[Dict[str, Any]]:
        return self._read_meta("plan.json")

    def write_report(self, report: Dict[str, Any]) -> None:
        with open(os.path.join(self.root, "report.json"), "w") as f:
            json.dump(report, f, indent=2)

    def read_report(self) -> Optional[Dict[str, Any]]:
        return self._read_meta("report.json")

    def _read_meta(self, name: str) -> Optional[Dict[str, Any]]:
        path = os.path.join(self.root, name)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    # ---- query layer ---------------------------------------------------
    def grouped(self, ignore: Sequence[str] = ("seed",)
                ) -> Dict[str, List[Any]]:
        """Completed cells grouped by their manifest with ``ignore``-d
        top-level scenario fields dropped (default: collapse the seed
        axis).  Key = canonical JSON of the reduced manifest; values in
        key-sorted cell order."""
        groups: Dict[str, List[Any]] = {}
        for key in sorted(self.completed()):
            res = self.load_cell(key)
            d = res.scenario.to_dict()
            for f in ignore:
                d.pop(f, None)
            gk = json.dumps(d, sort_keys=True, separators=(",", ":"))
            groups.setdefault(gk, []).append(res)
        return groups

    def query(self, target_acc: Optional[float] = None,
              ignore: Sequence[str] = ("seed",)) -> List[Dict[str, Any]]:
        """Time-to-accuracy / cost table across the grid.

        Cells identical up to ``ignore`` are one row: eval curves are
        averaged across the group (seed-mean, the fig3/Table-I
        convention) and, when ``target_acc`` is given, the first eval
        point whose MEAN accuracy reaches the target yields the row's
        ``time_s`` / ``energy_j`` / ``round`` (None when never reached).
        Rows also carry total host wall and final accuracy, so cost
        queries need no re-run."""
        rows: List[Dict[str, Any]] = []
        for gk, results in self.grouped(ignore).items():
            sc = results[0].scenario
            acc = np.mean([r.acc for r in results], axis=0)
            row: Dict[str, Any] = {
                "method": sc.method,
                "dataset": sc.data.dataset.name,
                "num_clients": sc.fleet.num_clients,
                "num_clusters": sc.fleet.num_clusters,
                "cells": len(results),
                "seeds": sorted(r.scenario.seed for r in results),
                "final_acc": round(float(acc[-1]), 4),
                "final_acc_std": round(float(np.std(
                    [r.final_acc for r in results])), 4),
                "wall_s": round(float(sum(r.wall_s for r in results)), 4),
            }
            if target_acc is not None:
                time_m = np.mean([r.time_s for r in results], axis=0)
                energy_m = np.mean([r.energy_j for r in results], axis=0)
                hit = np.nonzero(acc >= target_acc)[0]
                row["target_acc"] = target_acc
                if hit.size:
                    i = int(hit[0])
                    row["time_s"] = round(float(time_m[i]), 3)
                    row["energy_j"] = round(float(energy_m[i]), 3)
                    row["round"] = int(results[0].round[i])
                else:
                    row["time_s"] = row["energy_j"] = row["round"] = None
            rows.append(row)
        rows.sort(key=lambda r: (r["dataset"], r["num_clients"],
                                 r["num_clusters"], r["method"]))
        return rows

    @staticmethod
    def format_table(rows: List[Dict[str, Any]]) -> str:
        """ASCII rendering of :meth:`query` rows."""
        if not rows:
            return "(no completed cells)"
        with_tta = "time_s" in rows[0]
        head = "dataset          |   N |  K | method         | cells | final_acc"
        if with_tta:
            head += " | t_to_acc_s | e_to_acc_J | round"
        out = [head, "-" * len(head)]
        for r in rows:
            line = (f"{r['dataset']:<16} |{r['num_clients']:4d} |"
                    f"{r['num_clusters']:3d} | {r['method']:<14} |"
                    f"{r['cells']:6d} |    {r['final_acc']:.3f}")
            if with_tta:
                if r["time_s"] is None:
                    line += " |        inf |        inf |   inf"
                else:
                    line += (f" |{r['time_s']:11.0f} |{r['energy_j']:11.0f}"
                             f" |{r['round']:6d}")
            out.append(line)
        return "\n".join(out)
