"""The port's dry run (``launch/dryrun.py``, ``launch/hlo_analysis.py``)
against the JAX package's, and against hand counts, on the CPU.

* Argument and output bytes of the train, prefill and decode bundles of
  gemma2-2b, mixtral-8x22b (MoE) and mamba2-1.3b (SSD caches), smoke
  variants and an f32 profile, equal the reference's ``memory_summary``
  of the same bundles compiled on ``make_test_mesh((1, 1))``, with two
  differences named and sized: XLA's output is one tuple, whose index
  table adds 8 bytes a leaf to ``output_size_in_bytes``; and ``jax.jit``
  drops an argument the step never reads (mamba2's decode position: 4
  bytes, which the port's decode step takes as a 0-d int32 tensor).
* The client-mesh train step's collective bytes in a stage-2 round, kind
  by kind, equal the reference's ``collective_bytes`` of its compiled
  shard_map step on 4 XLA host devices (a subprocess): all-reduces only,
  the stage-1 and stage-2 buffers and the loss.
* A smoke prefill's flops equal a hand count from the config's widths,
  exactly: the projections, the MLP and the last position's logits, 2
  flops a multiply-add, and flash's 4 D a live pair.
* The scaled train count (one microbatch of one client and the
  aggregation, each scaled by its trips) equals the full count at two
  clients and accumulation 2, exactly: flops, bytes and the memory
  analysis, peak included.
* Each kernel's fake gives the plain version's output shapes and dtypes;
  its flops are chip_smoke.py's bound formula (its ``flash_pairs``; 2 C K
  P; N K (2 D + 3)) and its bytes, the op's inputs and outputs, are the
  bytes the bound moves (chip_smoke's ``stage1_bytes`` for a stage-1).
  Nothing is built or launched.
* The live-byte peak and the alias of a hand-made step, the CLI's exit
  codes, the layouts (``clients`` leaves no process group, even on an
  error; ``single`` and ``multi`` skip every pair naming the missing
  tensor parallelism), and the launchers' ``--dry-run``.
"""
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

import jax
import pytest
import torch
import torch.distributed as dist

from repro import configs as jconfigs
from repro.configs import shapes as jshapes
from repro.launch import hlo_analysis as jhlo
from repro.launch import steps as jsteps
from repro.launch.mesh import make_test_mesh
from repro_torch import configs as tconfigs
from repro_torch.configs import shapes as tshapes
from repro_torch.kernels import build, ops, ref
from repro_torch.launch import dryrun
from repro_torch.launch import hlo_analysis as H
from repro_torch.launch import steps as tsteps
from repro_torch.tree import tree_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_S, TRAIN_B = 64, 4          # one client on the (1, 1) mesh
SERVE_S, SERVE_B = 80, 2


def _chip_smoke():
    """chip_smoke.py as a module (its bound formulas; it imports nothing
    at the top but the standard library)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _profiles(monkeypatch, arch):
    """The smoke variant and an f32 profile in both packages."""
    jcfg = jconfigs.smoke_variant(jconfigs.get_config(arch))
    jprof = dataclasses.replace(jconfigs.get_profile(arch),
                                param_dtype="float32")
    monkeypatch.setattr(jsteps, "get_config", lambda arch: jcfg)
    monkeypatch.setattr(jsteps, "get_profile", lambda arch: jprof)
    tcfg = tconfigs.smoke_variant(tconfigs.get_config(arch))
    tprof = dataclasses.replace(tconfigs.get_profile(arch),
                                param_dtype="float32")
    return dict(cfg=tcfg, profile=tprof)


def _reference_memory(arch, mode, seq, batch):
    mesh = make_test_mesh((1, 1))
    with mesh:
        kw = {"num_clusters": 1} if mode == "train" else {}
        b = jsteps.build_step(arch, jshapes.InputShape("s", seq, batch, mode),
                              mesh, **kw)
        donate = {"train": (0,), "decode": (1,)}.get(mode, ())
        compiled = jax.jit(b.fn, in_shardings=b.in_shardings,
                           out_shardings=b.out_shardings,
                           donate_argnums=donate).lower(*b.in_specs).compile()
    return jhlo.memory_summary(compiled)


def _port_count(arch, mode, seq, batch, kw):
    shape = tshapes.InputShape("s", seq, batch, mode)
    if mode == "train":
        b = tsteps.build_train_step(arch, shape, None, num_clients=1,
                                    num_clusters=1, use_kernels=True, **kw)
        return b, H.count(b.fn, b.in_specs[:2] + (0,), device="meta",
                          trips=True)
    b = tsteps.build_step(arch, shape, None, **kw)
    return b, H.count(b.fn, b.in_specs, device="meta")


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["gemma2-2b", "mixtral-8x22b",
                                  "mamba2-1.3b"])
def test_argument_and_output_bytes_match_reference(monkeypatch, arch, mode):
    """The port's counted argument and output bytes against the
    reference's compiled ``memory_summary``: equal, less XLA's output
    tuple table (8 bytes a leaf) and an argument jit drops unread."""
    kw = _profiles(monkeypatch, arch)
    seq, batch = ((TRAIN_S, TRAIN_B) if mode == "train"
                  else (SERVE_S, SERVE_B))
    want = _reference_memory(arch, mode, seq, batch)
    bundle, c = _port_count(arch, mode, seq, batch, kw)
    got = H.memory_summary(c)
    n_out = c["n_outputs"]
    # mamba2's decode never reads its position: jit drops the argument
    unread = 4 if (arch, mode) == ("mamba2-1.3b", "decode") else 0
    assert got["argument_size_in_bytes"] - unread == \
        want["argument_size_in_bytes"]
    assert got["output_size_in_bytes"] + 8 * n_out == \
        want["output_size_in_bytes"]
    if mode == "decode":        # the caches, written in place
        assert got["alias_size_in_bytes"] > 0.9 * got["output_size_in_bytes"]
    assert got["total_hbm_bytes"] >= (got["argument_size_in_bytes"]
                                      + got["output_size_in_bytes"]
                                      - got["alias_size_in_bytes"])


REFERENCE_COLLECTIVES = r"""
import dataclasses, json, sys
import jax
from repro.configs import get_config, get_profile, smoke_variant
from repro.configs.shapes import InputShape
from repro.launch import hlo_analysis as H
from repro.launch import steps
from repro.launch.mesh import make_test_mesh
spec = {spec}
cfg = smoke_variant(get_config(spec["arch"]))
prof = dataclasses.replace(get_profile(spec["arch"]), param_dtype="float32")
steps.get_config = lambda arch: cfg
steps.get_profile = lambda arch: prof
mesh = make_test_mesh((spec["C"], 1))
with mesh:
    b = steps.build_train_step(
        spec["arch"], InputShape("t", spec["S"], spec["B"], "train"), mesh,
        num_clusters=spec["K"], rounds_per_global=spec["rpg"])
    compiled = jax.jit(b.fn, in_shardings=b.in_shardings,
                       out_shardings=b.out_shardings,
                       donate_argnums=(0,)).lower(*b.in_specs).compile()
print(json.dumps(H.collective_bytes(compiled.as_text())))
"""


def test_client_mesh_collective_bytes_match_reference():
    """A stage-2 round of the client-mesh train step (4 clients, 2
    clusters, rank 0 of a fake process group) against the reference's
    HLO count of its shard_map step on 4 host devices: the same kinds and
    bytes (stage-1: 4 (P + 2) bytes, stage-2: 4 (P + 1), the loss: 4)."""
    spec = dict(arch="gemma2-2b", C=4, K=2, S=64, B=8, rpg=2)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    res = subprocess.run(
        [sys.executable, "-c", REFERENCE_COLLECTIVES.format(spec=spec)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    want = json.loads(res.stdout.strip().splitlines()[-1])

    cfg = tconfigs.smoke_variant(tconfigs.get_config("gemma2-2b"))
    prof = dataclasses.replace(tconfigs.get_profile("gemma2-2b"),
                               param_dtype="float32")
    mesh = dryrun.ShapeMesh({"data": 4, "model": 1})
    with H.fake_process_group(4):
        b = tsteps.build_train_step(
            "gemma2-2b", tshapes.InputShape("t", 64, 8, "train"), mesh,
            num_clusters=2, rounds_per_global=2, cfg=cfg, profile=prof)
        rows = (_rows(b.in_specs[0]), _rows(b.in_specs[1]))
        c = H.count(b.fn, rows + (1,), device="meta", trips=True)
    assert not dist.is_initialized()
    got = H.collective_bytes(c)
    p = sum(s[0].numel() for s in tree_leaves(b.in_specs[0]))
    assert got == want == {"all-reduce": 4 * (p + 2) + 4 * (p + 1) + 4,
                           "total": 4 * (p + 2) + 4 * (p + 1) + 4}


def _rows(tree):
    """Rank 0's rows, (1, ...), of a (C, ...) spec tree."""
    if isinstance(tree, dict):
        return {k: _rows(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_rows(v) for v in tree)
    return torch.empty((1,) + tuple(tree.shape[1:]), dtype=tree.dtype,
                       device="meta")


def test_smoke_prefill_flops_equal_a_hand_count():
    """gemma2-2b's smoke variant (a local layer, window 64, and a global
    one), B = 2 prompts of 200 tokens: every projection and MLP product at
    2 flops a multiply-add, flash at 4 D a live pair of each query head
    (the causal band, cut to the window in the local layer), the logits of
    the last position only.  Exact: no other op has a flop formula."""
    cfg = tconfigs.smoke_variant(tconfigs.get_config("gemma2-2b"))
    b, s = 2, 200
    rec = dryrun.run_one("gemma2-2b", "prefill_32k", cfg=cfg, batch=b,
                         seq_len=s)
    d, h, hkv, hd, f = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                        cfg.head_dim, cfg.d_ff)
    per_layer = 2 * b * s * (d * h * hd + 2 * d * hkv * hd + h * hd * d
                             + 3 * d * f)
    pairs = {"global": s * (s + 1) // 2,
             "local": sum(min(i + 1, cfg.window_size) for i in range(s))}
    attn = sum(4 * hd * b * h * pairs[k] for k in cfg.layer_kinds())
    vocab = tsteps._param_structs(cfg)["embed"]["embedding"].shape[0]
    want = cfg.num_layers * per_layer + attn + 2 * b * d * vocab
    assert rec["cost"]["flops"] == want


@pytest.mark.parametrize("arch", ["gemma2-2b", "mamba2-1.3b"])
def test_scaled_train_count_equals_the_full_count(arch):
    """Two clients, accumulation 2: the count that runs one microbatch of
    one client and scales it by its trips equals the count of every
    trip, in flops, bytes accessed and every memory figure."""
    cfg = tconfigs.smoke_variant(tconfigs.get_config(arch))
    prof = dataclasses.replace(tconfigs.get_profile(arch), grad_accum=2)
    b = tsteps.build_train_step(arch, tshapes.InputShape("t", 64, 8,
                                                         "train"), None,
                                num_clients=2, num_clusters=2,
                                rounds_per_global=2, use_kernels=True,
                                cfg=cfg, profile=prof)
    assert (b.meta["accum"], b.meta["n_clients"]) == (2, 2)
    scaled, full = (H.count(b.fn, b.in_specs[:2] + (1,), device="meta",
                            trips=trips) for trips in (True, False))
    assert scaled["counter"].trip_counts == [2, 2]
    assert full["counter"].trip_counts == []
    assert H.cost_summary(scaled) == H.cost_summary(full)
    assert H.memory_summary(scaled) == H.memory_summary(full)


def _kernel_cases(cs):
    """(name, wrapper call, plain call, inputs, flops, bytes) a kernel."""
    q, k = (2, 8, 96, 64), (2, 4, 160, 64)
    leaves = [(4, 10, 3), (4, 7)]
    return [
        ("flash_attention",
         lambda x: ops.flash_attention(*x, causal=True, window=40),
         lambda x: ref.flash_attention_ref(*x, causal=True, window=40),
         [(q, torch.bfloat16), (k, torch.bfloat16), (k, torch.bfloat16)],
         4 * 64 * 2 * 8 * cs.flash_pairs(96, 160, True, 40),
         2 * (2 * 2 * 8 * 96 * 64 + 2 * 2 * 4 * 160 * 64)),
        ("weighted_agg_multi",
         lambda x: ops.weighted_agg_multi_tree(tuple(x[:2]), x[2]),
         lambda x: tuple(ref.weighted_agg_multi_ref(
             y.reshape(4, -1), x[2]).reshape((3,) + y.shape[1:])
             for y in x[:2]),
         [(leaves[0], torch.float32), (leaves[1], torch.float32),
          ((4, 3), torch.float32)],
         2 * 4 * 3 * (30 + 7), cs.stage1_bytes(4, 3, [30, 7], 4)),
        ("weighted_agg",
         lambda x: ops.weighted_agg(*x),
         lambda x: ref.weighted_agg_ref(*x),
         [((16, 50), torch.float32), ((16,), torch.float32)],
         2 * 16 * 50, 4 * (16 * 50 + 16 + 50)),
        ("kmeans_assign",
         lambda x: ops.kmeans_assign(*x),
         lambda x: ref.kmeans_assign_ref(*x),
         [((100, 3), torch.float32), ((4, 3), torch.float32)],
         100 * 4 * (2 * 3 + 3), 4 * (100 * 3 + 4 * 3 + 2 * 100)),
    ]


@pytest.mark.parametrize("case", range(4), ids=[
    "flash_attention", "weighted_agg_multi", "weighted_agg",
    "kmeans_assign"])
def test_kernel_fakes_give_plain_shapes_and_bound_formulas(monkeypatch,
                                                          case):
    """Each wrapper on fake tensors: the plain version's output shapes and
    dtypes (on CPU tensors of the same shapes), its flops by chip_smoke's
    bound formula, its bytes the bound's; no build, no launch."""
    monkeypatch.setattr(build, "load", _no_build)
    monkeypatch.setattr(build, "build_all", _no_build)
    cs = _chip_smoke()
    name, call, plain, inputs, flops, n_bytes = _kernel_cases(cs)[case]
    gen = torch.Generator().manual_seed(0)
    real = [torch.rand(s, generator=gen).to(dt) for s, dt in inputs]
    want = [(tuple(t.shape), t.dtype) for t in tree_leaves(plain(real))]
    ops.reset_launches()
    counter = H.Counter()
    with H.FakeTensorMode(allow_non_fake_inputs=True):
        fake = [torch.empty(s, dtype=dt, device="meta") for s, dt in inputs]
        with counter:
            out = call(fake)
        got = [(tuple(t.shape), t.dtype) for t in tree_leaves(out)]
    assert got == want
    assert counter.flops == flops
    assert counter.bytes_accessed == n_bytes
    assert set(ops.LAUNCHES.values()) == {0}


def _no_build(*args, **kwargs):
    raise AssertionError("a dry run built a kernel")


def test_counter_peak_and_alias_of_a_hand_step():
    """A step that makes two temporaries, frees one, writes its first
    argument in place and returns a new tensor and that argument: the
    peak counts the arguments and the two temporaries at once, the alias
    the argument written."""
    def step(a, b):
        t1 = a * 2.0                     # 400 bytes
        t2 = t1 + b                      # 400 bytes: a, b, t1, t2 live
        del t1
        a.add_(1.0)
        return t2.sum(), a

    c = H.count(step, (torch.empty((100,), device="meta"),
                       torch.empty((100,), device="meta")), device="meta")
    mem = H.memory_summary(c)
    assert mem["argument_size_in_bytes"] == 800
    assert mem["output_size_in_bytes"] == 404        # the sum and a
    assert mem["alias_size_in_bytes"] == 400
    assert mem["total_hbm_bytes"] == 1600
    assert mem["temp_size_in_bytes"] == 1600 - 800 - 404 + 400
    assert H.cost_summary(c)["bytes_accessed"] == (
        800 + 1200 + 800 + 404)   # mul, add, add_, sum


def test_cli_exit_codes(tmp_path, monkeypatch, capsys):
    """0 when every pair counts or is skipped (long_500k of an arch
    without a bounded state is skipped), 1 when one errs; each record a
    JSON line."""
    out = tmp_path / "runs.jsonl"
    assert dryrun.main(["--arch", "pixtral-12b", "--smoke", "--shape",
                        "long_500k", "--out", str(out)]) == 0
    assert dryrun.main(["--arch", "gemma2-2b", "--smoke", "--shape",
                        "decode_32k", "--out", str(out)]) == 0
    recs = [json.loads(x) for x in out.read_text().splitlines()]
    assert [r["status"] for r in recs] == ["skipped", "ok"]
    assert recs[1]["memory"]["alias_size_in_bytes"] > 0

    def broken(*args, **kwargs):
        raise RuntimeError("a broken step")
    monkeypatch.setattr(tsteps, "build_step", broken)
    assert dryrun.main(["--arch", "gemma2-2b", "--smoke", "--shape",
                        "decode_32k", "--out", str(out)]) == 1
    rec = json.loads(out.read_text().splitlines()[-1])
    assert rec["status"] == "error" and "a broken step" in rec["error"]
    assert "[dryrun] gemma2-2b x decode_32k x one: error" in \
        capsys.readouterr().out


def test_clients_layout_leaves_no_process_group(monkeypatch):
    """A ``clients`` count runs as rank 0 of a fake group of the mesh's W
    (16 for gemma2-2b's data-client profile) and destroys it, also when
    the step raises; a serving pair is skipped there."""
    rec = dryrun.run_one("gemma2-2b", "train_4k", "clients", smoke=True,
                         seq_len=64)
    assert rec["status"] == "ok" and rec["devices"] == 16
    assert rec["meta"]["world"] == 16 and rec["meta"]["pcb"] == 16
    assert rec["collectives"]["all-reduce"] > 0
    assert not dist.is_initialized()
    skipped = dryrun.run_one("gemma2-2b", "decode_32k", "clients")
    assert skipped["status"] == "skipped"
    assert skipped["reason"] == dryrun.NO_SERVE_MESH

    def broken(*args, **kwargs):
        raise RuntimeError("a broken step")
    monkeypatch.setattr(tsteps, "build_train_step", broken)
    with pytest.raises(RuntimeError, match="a broken step"):
        dryrun.run_one("gemma2-2b", "train_4k", "clients", smoke=True)
    assert not dist.is_initialized()


def test_every_production_mesh_pair_names_tensor_parallelism(capsys):
    """``--mesh both``: every pair of every arch skipped, each reason
    naming the missing tensor parallelism (and, for a long_500k pair that
    ``shape_applicable`` rejects, its reason too); the exit code 0."""
    assert dryrun.main(["--all", "--mesh", "both"]) == 0
    lines = [x for x in capsys.readouterr().out.splitlines()
             if " x " in x]
    assert len(lines) == 2 * len(tconfigs.ARCH_NAMES) * len(tshapes.SHAPES)
    assert all(": skipped (" + dryrun.NO_TP in x for x in lines)
    rec = dryrun.run_one("grok-1-314b", "long_500k", "16x16")
    assert rec["reason"].endswith("no windowed variant implemented")


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_production_meshes_skip_naming_tensor_parallelism(shape):
    """16x16: skipped for want of tensor parallelism, with the bytes a
    device holds under the placements: the full gemma2-2b's arguments
    split where they divide (its 256,000-row embedding over "model", the
    clients of a train step over "data")."""
    rec = dryrun.run_one("gemma2-2b", shape, "16x16")
    assert rec["status"] == "skipped" and rec["reason"] == dryrun.NO_TP
    assert rec["devices"] == 256
    cfg = tconfigs.get_config("gemma2-2b")
    params = tsteps._param_structs(cfg)
    full = sum(s.numel() * 2 for s in tree_leaves(params))    # bf16
    per_device = rec["memory"]["argument_size_in_bytes"]
    assert 0 < per_device < full


def test_launchers_dry_run(capsys):
    """``launch/train.py --dry-run`` and ``launch/serve.py --dry-run
    --shape`` print the reference's analyses (the per-device total, the
    memory analysis, flops and bytes accessed)."""
    from repro_torch.launch import serve, train
    train.main(["--dry-run", "--smoke", "--device", "cpu"])
    serve.main(["--dry-run", "--smoke", "--shape", "prefill_32k"])
    out = capsys.readouterr().out
    assert out.count("per-device HBM") == 2
    assert out.count("'bytes accessed'") == 2
    assert out.count("argument_size_in_bytes") == 2
    with pytest.raises(SystemExit, match="train shape"):
        serve.main(["--dry-run", "--smoke", "--shape", "train_4k"])
