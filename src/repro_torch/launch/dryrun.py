"""The dry run: count every (arch x input-shape) step on fake tensors and
record its memory, cost and collective analysis.

    python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k
    python -m repro_torch.launch.dryrun --all --mesh one --out runs.jsonl

Counterpart of ``repro/launch/dryrun.py``.  The reference lowers and
compiles each step on its production meshes with ``ShapeDtypeStruct``
inputs; PyTorch compiles nothing, so here each step runs once on fake
tensors (`launch/hlo_analysis.py`): nothing is computed or allocated and
no kernel is built or launched, and every layer, microbatch and client
counts.  The tensors are fake ``cuda`` tensors where CUDA is present and
fake ``meta`` ones elsewhere (a CPU-only torch cannot index a ``cuda``
tensor, even a fake one); the port routes every tensor off the CPU alike
(`kernels/ops.py`: the kernels' ops, the chunked train attention), so
both count the card's route.

``--mesh`` takes the layouts the port has:

* ``one`` (the default): one card, no mesh, as ``launch/serve.py`` and
  ``launch/train.py`` run.  A serving step runs at the shape's batch and
  length (a decode step over a cache of that length); the train step at
  ``launch/train.py``'s defaults (C = 4 clients stacked, K = 2, a global
  batch of 16, stage-2 every 2 rounds), a stage-2 round, stage-1 through
  the kernel.  Its count runs one microbatch of one client and the
  aggregation, and scales them by their trips (``meta.trip_counts``).
* ``clients``: the port's client mesh, one whole client a rank, W the
  clients the reference's single-pod mesh gives the arch (16 for a
  data-client profile, 1 for a pod-client one), the shape's global batch;
  counted as rank 0 of a ``fake`` process group.  Serving pairs are
  skipped: the port's serving steps have no mesh program.
* ``single``, ``multi``, ``both``: the reference's 16x16 and 2x16x16
  meshes.  Their steps shard over "model", and the port has no tensor
  parallelism: each pair is skipped with that reason, its
  ``memory.argument_size_in_bytes`` the largest a device holds under
  `sharding/rules.py`'s placements (which need no program).

A record keeps the reference's keys and statuses (``ok``, ``skipped``,
``error``), ``count_s`` in place of ``lower_s``/``compile_s``.  The exit
code is 0 iff every attempted pair counted.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
import traceback
from typing import Any, Dict

import torch

from repro_torch import configs
from repro_torch.configs.shapes import SHAPES, InputShape, shape_applicable
from repro_torch.launch import hlo_analysis as H
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.tree import tree_leaves, tree_map

LAYOUTS = {"one": ["one"], "clients": ["clients"], "single": ["16x16"],
           "multi": ["2x16x16"], "both": ["16x16", "2x16x16"]}
NO_TP = ("the port has no tensor parallelism over 'model' (launch/steps.py:"
         " one whole client a rank); ROADMAP queue 1")
NO_SERVE_MESH = "the port's serving steps have no mesh program"
# launch/train.py's defaults: the one-card run
TRAIN_CLIENTS, TRAIN_CLUSTERS, TRAIN_BATCH, TRAIN_RPG = 4, 2, 16, 2
MESH_RPG = 5                 # the reference's launcher's stage-2 cadence


class ShapeMesh:
    """A mesh's axis names and sizes, all `sharding/rules.py` reads."""

    def __init__(self, shape: Dict[str, int]):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def _production(layout: str) -> ShapeMesh:
    shape, axes = (mesh_lib.MULTI_POD_SHAPE if layout == "2x16x16"
                   else mesh_lib.PRODUCTION_SHAPE)
    return ShapeMesh(dict(zip(axes, shape)))


def count_device() -> str:
    """Where the fake tensors sit: ``cuda`` with CUDA, else ``meta``."""
    return "cuda" if torch.cuda.is_available() else "meta"


def _config(arch: str, overrides: Dict[str, Any]):
    cfg = overrides.pop("cfg", None) or configs.get_config(arch)
    if overrides.pop("smoke", False):
        cfg = configs.smoke_variant(cfg)
    layers = overrides.pop("num_layers", None)
    if layers:
        cfg = configs.replace(cfg, num_layers=layers)
    return cfg, overrides.pop("profile", None) or configs.get_profile(arch)


def _per_device_bytes(specs, placements, sizes) -> int:
    """The bytes a device holds of ``specs`` under ``placements`` (a
    tuple of per-axis placements a leaf): each leaf's bytes over the
    sizes of the mesh axes it is sharded on."""
    if isinstance(specs, torch.Tensor):
        split = math.prod(n for n, p in zip(sizes, placements)
                          if p.is_shard())
        return specs.numel() * specs.element_size() // split
    if isinstance(specs, dict):
        return sum(_per_device_bytes(specs[k], placements[k], sizes)
                   for k in specs)
    if isinstance(specs, (tuple, list)):
        return sum(_per_device_bytes(a, b, sizes)
                   for a, b in zip(specs, placements))
    return 0


def _record(c: Dict[str, Any], devices: int) -> Dict[str, Any]:
    mem = H.memory_summary(c)
    return dict(status="ok", count_s=round(c["count_s"], 2), devices=devices,
                memory=mem,
                per_device_hbm_gb=round(mem["total_hbm_bytes"] / 2**30, 3),
                cost=H.cost_summary(c), collectives=H.collective_bytes(c))


def _one(arch, shape: InputShape, cfg, prof, overrides, device):
    if shape.mode == "train":
        c = overrides.pop("clients", TRAIN_CLIENTS)
        k = overrides.pop("clusters", TRAIN_CLUSTERS)
        rpg = overrides.pop("rounds_per_global", TRAIN_RPG)
        shape = dataclasses.replace(
            shape, global_batch=overrides.pop("global_batch", TRAIN_BATCH),
            seq_len=overrides.pop("seq_len", shape.seq_len))
        bundle = steps.build_train_step(
            arch, shape, None, num_clusters=k, rounds_per_global=rpg,
            num_clients=c, use_kernels=True, cfg=cfg, profile=prof)
        args = bundle.in_specs[:2] + (rpg - 1,)       # a stage-2 round
        c_ = H.count(bundle.fn, args, device=device, trips=True)
        trips = {"clients": c, "microbatches": bundle.meta["accum"]}
        meta = dict(bundle.meta, round_idx=rpg - 1, did_global=True,
                    global_batch=shape.global_batch, seq=shape.seq_len)
    else:
        shape = dataclasses.replace(
            shape, global_batch=overrides.pop("batch", shape.global_batch),
            seq_len=overrides.pop("seq_len", shape.seq_len))
        bundle = steps.build_step(arch, shape, None, cfg=cfg, profile=prof)
        meta = dict(bundle.meta, batch=shape.global_batch, seq=shape.seq_len)
        c_ = H.count(bundle.fn, bundle.in_specs, device=device)
        trips = {}
    return c_, 1, meta, trips


def _clients(arch, shape: InputShape, cfg, prof, overrides, device):
    world = mesh_lib.num_clients_for(_production("16x16"), prof.client_axis)
    mesh = ShapeMesh({"data": world, "model": 1}
                     if prof.client_axis == "data"
                     else {"pod": world, "data": 1, "model": 1})
    shape = dataclasses.replace(
        shape, global_batch=overrides.pop("global_batch",
                                          shape.global_batch),
        seq_len=overrides.pop("seq_len", shape.seq_len))
    k = overrides.pop("clusters", 4)
    rpg = overrides.pop("rounds_per_global", MESH_RPG)
    with H.fake_process_group(world):
        bundle = steps.build_train_step(
            arch, shape, mesh, num_clusters=k, rounds_per_global=rpg,
            cfg=cfg, profile=prof)
        # rank 0's rows: (1, ...) of the stack and of the batch
        rows = tree_map(lambda s: torch.empty((1,) + tuple(s.shape[1:]),
                                              dtype=s.dtype, device="meta"),
                        bundle.in_specs[:2])
        c_ = H.count(bundle.fn, rows + (rpg - 1,), device=device,
                     trips=True)
    meta = dict(bundle.meta, round_idx=rpg - 1, did_global=True,
                global_batch=shape.global_batch, seq=shape.seq_len,
                rank=0, world=world)
    return c_, world, meta, {"microbatches": bundle.meta["accum"]}


def _skipped_on_mesh(arch, shape: InputShape, layout, cfg, prof):
    mesh = _production(layout)
    if shape.mode == "train":
        specs, sh = steps.train_placements(arch, shape, mesh, cfg=cfg,
                                           profile=prof)
    else:
        b = steps.build_step(arch, shape, mesh, cfg=cfg, profile=prof)
        specs, sh = b.in_specs, b.in_shardings
    return dict(status="skipped", reason=NO_TP, mode=shape.mode,
                devices=math.prod(mesh.shape.values()),
                memory={"argument_size_in_bytes": float(_per_device_bytes(
                    specs, sh, list(mesh.shape.values())))})


def run_one(arch: str, shape_name: str, mesh: str = "one",
            **overrides) -> Dict[str, Any]:
    """One (arch, shape) pair on one layout (``one``, ``clients``,
    ``16x16`` or ``2x16x16``).  ``overrides``: ``cfg``, ``profile``,
    ``smoke``, ``num_layers`` (the config), ``batch``, ``seq_len`` (a
    serving step), ``clients``, ``clusters``, ``global_batch``,
    ``seq_len``, ``rounds_per_global`` (a train step), ``device`` (of the
    fake tensors)."""
    overrides = dict(overrides)
    device = overrides.pop("device", None) or count_device()
    cfg, prof = _config(arch, overrides)
    shape = SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh}
    ok, reason = shape_applicable(cfg, shape)
    if mesh in ("16x16", "2x16x16"):
        if ok:
            rec.update(_skipped_on_mesh(arch, shape, mesh, cfg, prof))
        else:               # no step to place either
            rec.update(status="skipped", reason=f"{NO_TP}; {reason}")
        return rec
    if not ok:
        rec.update(status="skipped", reason=reason)
        return rec
    if mesh == "clients" and shape.mode != "train":
        rec.update(status="skipped", reason=NO_SERVE_MESH, mode=shape.mode)
        return rec
    if mesh not in ("one", "clients"):
        raise ValueError(f"unknown layout {mesh!r}")
    run = _one if mesh == "one" else _clients
    c, devices, meta, trips = run(arch, shape, cfg, prof, overrides, device)
    if overrides:
        raise TypeError(f"run_one: unknown overrides {sorted(overrides)}")
    if trips and sorted(c["counter"].trip_counts) != sorted(trips.values()):
        raise RuntimeError(f"trips {c['counter'].trip_counts} against the "
                           f"step's {trips}")
    meta = {k: v for k, v in meta.items() if k != "clusters"}
    meta.update(trip_counts=trips, device=device, layers=cfg.num_layers,
                params=sum(s.numel() for s in tree_leaves(
                    steps._param_structs(cfg))))
    rec.update(mode=shape.mode, **_record(c, devices), meta=meta)
    return rec


def print_analyses(rec: Dict[str, Any]) -> None:
    """A counted step's analyses, as the reference's launchers print a
    compiled one's under ``--dry-run``: the per-device peak, the memory
    analysis, the flops and bytes accessed."""
    mem, cost = rec["memory"], rec["cost"]
    print(f"counted in {rec['count_s']:.1f}s; per-device HBM "
          f"{mem['total_hbm_bytes'] / 2**30:.2f} GiB", flush=True)
    print(mem)
    print({"flops": cost["flops"], "bytes accessed": cost["bytes_accessed"]})
    if rec["collectives"].get("total"):
        print({"collectives": rec["collectives"]})


def _line(tag: str, rec: Dict[str, Any]) -> str:
    status = rec["status"]
    if status == "ok":
        extra = (f" hbm/dev={rec['per_device_hbm_gb']}GB"
                 f" flops={rec['cost']['flops']:.3e}"
                 f" coll={rec['collectives'].get('total', 0) / 2**30:.2f}GB"
                 f" count={rec['count_s']}s")
    elif status == "skipped":
        extra = f" ({rec['reason']})"
    else:
        extra = f" {rec['error']}"
    return f"[dryrun] {tag}: {status}{extra}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=list(LAYOUTS), default="one")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="the configs' reduced smoke_variant")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut each arch's depth to this many layers")
    ap.add_argument("--clients", type=int, default=None,
                    help="a one-card train step's clients (default 4)")
    ap.add_argument("--out", default=None, help="JSONL output path")
    args = ap.parse_args(argv)

    archs = (list(configs.ARCH_NAMES) if (args.all or not args.arch)
             else [args.arch])
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    out_f = open(args.out, "a") if args.out else None
    failures = 0
    t0 = time.perf_counter()
    try:
        for arch in archs:
            for shape in shapes:
                for layout in LAYOUTS[args.mesh]:
                    tag = f"{arch} x {shape} x {layout}"
                    kw = dict(smoke=args.smoke, num_layers=args.layers)
                    if args.clients and SHAPES[shape].mode == "train":
                        kw["clients"] = args.clients
                    try:
                        rec = run_one(arch, shape, layout, **kw)
                    except Exception as e:  # noqa: BLE001
                        rec = {"arch": arch, "shape": shape, "mesh": layout,
                               "status": "error", "error": repr(e),
                               "trace": traceback.format_exc()[-2000:]}
                        failures += 1
                    print(_line(tag, rec), flush=True)
                    if rec["status"] == "error":
                        print(rec["trace"], flush=True)
                    if out_f:
                        out_f.write(json.dumps(rec) + "\n")
                        out_f.flush()
    finally:
        if out_f:
            out_f.close()
    print(f"[dryrun] {len(archs) * len(shapes) * len(LAYOUTS[args.mesh])} "
          f"pairs in {time.perf_counter() - t0:.1f}s, {failures} errors",
          flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
