"""The port's serving path within itself, on the CPU: decode after prefill
equals the full forward at the next position (the checks of
``tests/test_decode_consistency.py``, for the attention and recurrent
layer kinds), ``serve_batch`` end to end, and the guard that no module of the
port imports JAX or the JAX package.

Both sides of each consistency check run in float32 through the same
functions, so they differ only in how attention and the recurrences are
split (the flash path, the chunked SSD and the log-depth scan over S + 1
tokens against the cached one-step decode path): 1e-4 on the logits.
"""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config, smoke_variant
from repro_torch.launch import serve
from repro_torch.models import decode_step, init_params, prefill
from repro_torch.models.transformer import forward

torch.set_num_threads(1)        # see test_torch_jaxref.py
ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
TOL = 1e-4


def _setup(arch, seed=0, B=2, S=48):
    cfg = smoke_variant(get_config(arch))
    gen = torch.Generator().manual_seed(seed)
    params = init_params(cfg, gen)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    return cfg, params, toks


@torch.inference_mode()
@pytest.mark.parametrize("arch", ["gemma2-2b", "h2o-danube-1.8b",
                                  "qwen2-72b", "mamba2-1.3b",
                                  "recurrentgemma-2b", "mixtral-8x22b"])
def test_decode_matches_full_forward(arch):
    cfg, params, toks = _setup(arch)
    S = toks.shape[1]
    logits_pf, caches = prefill(cfg, params, {"tokens": toks}, max_len=S + 4)
    nxt = logits_pf[:, -1:].argmax(-1)
    logits_dec, caches = decode_step(cfg, params, caches, nxt, S)
    full, _, _ = forward(cfg, params,
                         {"tokens": torch.cat([toks, nxt], 1)}, mode="train")
    torch.testing.assert_close(logits_dec[:, 0], full[:, -1], rtol=TOL,
                               atol=TOL)
    nxt2 = logits_dec[:, -1:].argmax(-1)
    logits_dec2, _ = decode_step(cfg, params, caches, nxt2, S + 1)
    full2, _, _ = forward(cfg, params,
                       {"tokens": torch.cat([toks, nxt, nxt2], 1)},
                       mode="train")
    torch.testing.assert_close(logits_dec2[:, 0], full2[:, -1], rtol=TOL,
                               atol=TOL)


@torch.inference_mode()
def test_ring_buffer_wraps_beyond_window():
    """Prefill past the window (S = 100 > 64), then decode: the ring cache
    must equal full-context attention restricted to the window."""
    cfg, params, toks = _setup("h2o-danube-1.8b", seed=1, B=1, S=100)
    assert cfg.window_size == 64
    S = toks.shape[1]
    logits_pf, caches = prefill(cfg, params, {"tokens": toks}, max_len=S + 8)
    assert caches["layers"][0]["k"].shape[2] == 64      # (cycles, B, L, H, D)
    nxt = logits_pf[:, -1:].argmax(-1)
    logits_dec, _ = decode_step(cfg, params, caches, nxt, S)
    full, _, _ = forward(cfg, params,
                         {"tokens": torch.cat([toks, nxt], 1)}, mode="train")
    torch.testing.assert_close(logits_dec[:, 0], full[:, -1], rtol=TOL,
                               atol=TOL)


@torch.inference_mode()
def test_recurrent_ring_buffer_wraps_beyond_window():
    """recurrentgemma (rglru, rglru, local): prefill past the local
    layers' window (S = 100 > 64), then two decode steps, each equal to the
    full forward; the RG-LRU states and the ring caches carry it."""
    cfg, params, toks = _setup("recurrentgemma-2b", seed=2, B=1, S=100)
    assert cfg.window_size == 64
    S = toks.shape[1]
    logits_pf, caches = prefill(cfg, params, {"tokens": toks}, max_len=S + 8)
    local, rec = caches["layers"][2], caches["layers"][0]
    assert local["k"].shape[2] == 64                    # (cycles, B, L, H, D)
    assert set(rec) == {"h", "conv"} and rec["h"].dtype == torch.float32
    seq = toks
    nxt = logits_pf[:, -1:].argmax(-1)
    for step in range(2):
        logits_dec, caches = decode_step(cfg, params, caches, nxt, S + step)
        seq = torch.cat([seq, nxt], 1)
        full, _, _ = forward(cfg, params, {"tokens": seq}, mode="train")
        torch.testing.assert_close(logits_dec[:, 0], full[:, -1], rtol=TOL,
                                   atol=TOL)
        nxt = logits_dec[:, -1:].argmax(-1)


# ------------------------------------------------------------ serve_batch

def test_serve_batch_smoke_is_deterministic():
    cfg, params, prompts = _setup("gemma2-2b", S=70)
    a = serve.serve_batch(cfg, params, prompts, 5, device="cpu")
    b = serve.serve_batch(cfg, params, prompts, 5, device="cpu")
    assert a.tokens.shape == (2, 5) and a.tokens.dtype == torch.int64
    assert torch.equal(a.tokens, b.tokens)
    assert int(a.tokens.min()) >= 0 and int(a.tokens.max()) < cfg.vocab_size
    assert a.prefill_s > 0 and a.decode_tokens_per_s > 0
    assert a.peak_device_mem_mb is None                  # no card here


def test_serve_cli_runs_on_cpu(capsys):
    serve.main(["--arch", "gemma2-2b", "--smoke", "--device", "cpu",
                "--batch", "1", "--prompt-len", "20", "--tokens", "3"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["arch"] == "gemma2-2b-smoke" and out["device"] == "cpu"
    assert len(out["first_tokens"]) == 1 and len(out["first_tokens"][0]) == 3


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-2b"])
def test_serve_cli_runs_recurrent_archs_on_cpu(arch, capsys):
    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "70", "--tokens", "3"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["arch"] == arch + "-smoke" and out["device"] == "cpu"
    assert [len(t) for t in out["first_tokens"]] == [3, 3]


def test_serving_defaults_to_cuda_and_refuses_to_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, params, prompts = _setup("gemma2-2b", S=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.serve_batch(cfg, params, prompts, 2)


@pytest.mark.parametrize("arch,name", [("whisper-large-v3", "frames"),
                                       ("pixtral-12b", "patch_embeds")])
def test_serve_cli_runs_frontend_archs_on_cpu(arch, name, capsys):
    """The encoder-decoder (frames encoded once, ``encode_s``) and the
    vision front end (patches in front of the prompt: the caches hold
    frontend_len + S + new_tokens positions) from the CLI, their inputs
    drawn from ``--seed``; the same seed gives the same tokens."""
    args = ["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
            "--prompt-len", "20", "--tokens", "3"]
    serve.main(args)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    cfg = smoke_variant(get_config(arch))
    assert out["arch"] == arch + "-smoke" and out["device"] == "cpu"
    assert out["frontend_len"] == cfg.frontend_len == 32
    assert (out["encode_s"] > 0) == (name == "frames")
    assert [len(t) for t in out["first_tokens"]] == [3, 3]
    n_pos = 20 + 3 + (32 if name == "patch_embeds" else 0)
    kv = 2 * 2 * n_pos * cfg.num_kv_heads * cfg.head_dim * 4
    assert out["cache_bytes"] == cfg.num_layers * (kv + 4 * n_pos)
    serve.main(args)
    again = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert again["first_tokens"] == out["first_tokens"]


@pytest.mark.parametrize("arch,kv_int8", [("grok-1-314b", True),
                                          ("mixtral-8x22b", False)])
def test_serve_cli_runs_moe_archs_on_cpu(arch, kv_int8, capsys):
    """The profiles' defaults: scan dispatch for both, grok-1's int8
    cache, whose bytes are (D + 4 bytes of scale) / (4 D) of the f32
    cache's at the smoke's D = 32."""
    args = ["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
            "--prompt-len", "70", "--tokens", "3"]
    serve.main(args)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["arch"] == arch + "-smoke" and out["device"] == "cpu"
    assert out["moe_dispatch"] == "scan" and out["kv_int8"] is kv_int8
    assert [len(t) for t in out["first_tokens"]] == [3, 3]
    flag = "--no-kv-int8" if kv_int8 else "--kv-int8"
    serve.main(args + [flag])
    other = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert other["kv_int8"] is not kv_int8
    q, f = ((out, other) if kv_int8 else (other, out))
    slots = q["cache_bytes"] - f["cache_bytes"] * (32 + 4) / (4 * 32)
    assert abs(slots) < 0.01 * q["cache_bytes"]     # slot_pos: int32 both


def test_moe_serving_refuses_to_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "grok-1-314b", "--smoke"])


# ------------------------------------------------------------------ guards

_BLOCK = r"^\s*(import|from)\s+(jax|repro)\b"


def test_port_and_chip_smoke_import_no_jax():
    """Every module of the port imports with ``jax`` and ``repro`` blocked,
    and neither the port nor chip_smoke.py names them in an import."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    extra = [ROOT / "chip_smoke.py", ROOT / "examples" / "quickstart_torch.py",
             ROOT / "examples" / "fl_transformer_torch.py",
             ROOT / "examples" / "serve_batch_torch.py"]
    for f in files + extra:
        for line in f.read_text().splitlines():
            assert not re.match(_BLOCK, line), f"{f}: {line}"
    mods = [".".join(f.relative_to(ROOT / "src").with_suffix("").parts)
            for f in files]
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = f"""
import importlib, importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, "examples")
for m in {mods!r} + ["quickstart_torch", "fl_transformer_torch",
                     "serve_batch_torch"]:
    importlib.import_module(m)
print(len({mods!r}))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) == len(mods) > 30
