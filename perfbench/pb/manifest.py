"""``BENCHMARK.json`` and the files it names.

A cell (``perfbench/workloads/<cell>.json``) names its configuration
(``perfbench/configs/<config>.json``), the driver that runs its window
(``perfbench/drivers/<driver>.py``) and its traffic parameters.  A
per-layer metric is read by ``perfbench/metrics/<metric>.py``.  All are
found by name, so a new cell, configuration or metric is new files and
new entries, never an edit.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Any, Dict, List

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH_RE = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> Dict[str, Any]:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return load_json(path)


def cell_file(name: str) -> Dict[str, Any]:
    path = BENCH_DIR / "workloads" / f"{name}.json"
    if not path.is_file():
        raise KeyError(f"no cell {name!r} ({path} is missing)")
    return load_json(path)


def config_file(name: str) -> Dict[str, Any]:
    return load_json(BENCH_DIR / "configs" / f"{name}.json")


def load_module(kind: str, name: str):
    """``perfbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = BENCH_DIR / kind / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {kind} module {name!r} ({path} is missing)")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_for(man: Dict[str, Any], cell: str, group: str
                ) -> List[Dict[str, Any]]:
    """The ``end_to_end`` or ``per_layer`` entries that ``cell`` reports:
    those without a ``workloads`` list, and those that list it."""
    return [m for m in man[group]
            if "workloads" not in m or cell in m["workloads"]]


def validate(man: Dict[str, Any]) -> List[str]:
    """The contract's limits on names, units, keys and cross-references:
    a list of faults, empty when the manifest is sound."""
    bad: List[str] = []
    top = {"command", "paths", "run_seconds", "configs", "workloads",
           "end_to_end", "per_layer"}
    if set(man) != top:
        bad.append(f"top-level keys {sorted(man)}")
    for p in man.get("paths", []):
        if not PATH_RE.match(p) or p.startswith("/") or ".." in p.split("/"):
            bad.append(f"path {p!r}")
    if not 1 <= len(man.get("paths", [])) <= 16:
        bad.append("paths: 1 to 16")
    cmd = man.get("command", [])
    if not 1 <= len(cmd) <= 32 or any(
            not 1 <= len(w) <= 200 or "\n" in w or "\t" in w for w in cmd):
        bad.append("command")
    rs = man.get("run_seconds")
    if not isinstance(rs, int) or not 1 <= rs <= 51:
        bad.append(f"run_seconds {rs!r}")

    def one_line(s, what):
        if not isinstance(s, str) or not 1 <= len(s) <= 200 or "\n" in s \
                or "\t" in s:
            bad.append(f"{what} {s!r}")

    names = set()
    configs = {}
    for c in man.get("configs", []):
        if set(c) != {"name", "source", "file", "reduced", "why"}:
            bad.append(f"config keys {sorted(c)}")
        if not NAME_RE.match(c.get("name", "")):
            bad.append(f"config name {c.get('name')!r}")
        one_line(c.get("source"), "config source")
        one_line(c.get("why"), "config why")
        if len(c.get("reduced", [])) > 16 or any(
                not NAME_RE.match(k) for k in c.get("reduced", [])):
            bad.append(f"reduced {c.get('reduced')!r}")
        if not any(c.get("file", "").startswith(p.rstrip("/") + "/")
                   for p in man.get("paths", [])):
            bad.append(f"config file {c.get('file')!r} outside paths")
        configs[c.get("name")] = c
    if not 1 <= len(configs) <= 24:
        bad.append("configs: 1 to 24")
    if len({c["file"] for c in configs.values()}) != len(configs):
        bad.append("two configs share a file")

    cells = {}
    pairs = set()
    for w in man.get("workloads", []):
        if set(w) != {"name", "config", "traffic", "chips", "why"}:
            bad.append(f"workload keys {sorted(w)}")
        for k in ("name", "config", "traffic"):
            if not NAME_RE.match(str(w.get(k, ""))):
                bad.append(f"workload {k} {w.get(k)!r}")
        one_line(w.get("why"), "workload why")
        if w.get("chips") not in (1, 4):
            bad.append(f"chips {w.get('chips')!r}")
        if w.get("config") not in configs:
            bad.append(f"workload {w.get('name')!r}: no config "
                       f"{w.get('config')!r}")
        pair = (w.get("config"), w.get("traffic"))
        if pair in pairs:
            bad.append(f"pair {pair} twice")
        pairs.add(pair)
        cells[w.get("name")] = w
    if not 1 <= len(cells) <= 24:
        bad.append("workloads: 1 to 24")
    used = {w.get("config") for w in cells.values()}
    for c in configs:
        if c not in used:
            bad.append(f"config {c!r} has no cell")

    metric_names = {}
    for group, keys in (("end_to_end", {"name", "unit", "better", "bound",
                                        "source"}),
                        ("per_layer", {"name", "unit", "better", "source",
                                       "layer", "moves"})):
        for m in man.get(group, []):
            if set(m) - {"workloads"} != keys:
                bad.append(f"{group} keys {sorted(m)}")
            if not NAME_RE.match(m.get("name", "")):
                bad.append(f"metric name {m.get('name')!r}")
            if not UNIT_RE.match(m.get("unit", "")):
                bad.append(f"unit {m.get('unit')!r}")
            if m.get("better") not in ("lower", "higher"):
                bad.append(f"better {m.get('better')!r}")
            if m.get("source") not in SOURCES:
                bad.append(f"source {m.get('source')!r}")
            for c in m.get("workloads", []):
                if c not in cells:
                    bad.append(f"{m.get('name')}: no cell {c!r}")
            metric_names.setdefault(m.get("name"), 0)
            metric_names[m.get("name")] += 1
    names |= set(metric_names)
    if any(n > 1 for n in metric_names.values()):
        bad.append("a metric name twice")
    e2e = {m["name"]: m for m in man.get("end_to_end", [])}
    if "setup_s" not in e2e:
        bad.append("no setup_s")
    for m in e2e.values():
        if m.get("source") not in ("host_clock", "device_trace"):
            bad.append(f"{m['name']}: end-to-end source")
        b = m.get("bound")
        if not isinstance(b, (int, float)) or not 0.01 <= b <= 0.25:
            bad.append(f"{m['name']}: bound {b!r}")
    for m in man.get("per_layer", []):
        one_line(m.get("layer"), "layer")
        if m.get("moves") not in e2e:
            bad.append(f"{m['name']}: moves {m.get('moves')!r}")
        for c in m.get("workloads", list(cells)):
            if c in cells and m.get("moves") not in [
                    x["name"] for x in metrics_for(man, c, "end_to_end")]:
                bad.append(f"{m['name']}: cell {c} lacks {m['moves']}")
    for c in cells:
        e = [x["name"] for x in metrics_for(man, c, "end_to_end")]
        if "setup_s" not in e or len(e) < 2:
            bad.append(f"cell {c}: end-to-end metrics {e}")
        if not metrics_for(man, c, "per_layer"):
            bad.append(f"cell {c}: no per-layer metric")
    return bad
