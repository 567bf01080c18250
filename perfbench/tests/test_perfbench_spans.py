"""The readers of the program's spans (`pb/spans.py`, the ``*_ms`` metrics
of `metrics/`): known intervals, each reader in its own unit, and their
None cases; on the card, a traced smoke Mixtral step's ``moe/experts``
time against its forward alone."""
import pytest
import torch

from pb import manifest
from pb.spans import device_ms, host_ms, minus
from pb.trace import WINDOW, Trace, merge

MS = 1_000_000          # ns
SYNC = {"aggregate_ms.round": "fed_step/aggregate",
        "recluster_ms.round": "fed_step/recluster",
        "eval_ms.round": "fed_step/eval"}
LM = {"moe_ms.lm_round": "moe/experts",
      "attention_ms.lm_round": "attention/core",
      "update_ms.lm_round": "lm_train/update"}


class _Fake:
    """A capture of known intervals (ns) in a 1 s window."""
    t0, t1 = 0, 1000 * MS

    def __init__(self, device, scopes, host=None):
        self.device = sorted(device)
        self.busy = merge((s, e) for s, e, _ in self.device)
        self.device_scopes = scopes
        self.host = host or {}


def _ctx(trace, unit, units=10):
    return {"trace": trace, "units": units, "unit": unit, "layer": {},
            "untraced": {"units": 20, "window_s": 1.6}}


def _read(name, ctx):
    return manifest.load_module("metrics", name).read(ctx)


def test_minus():
    assert minus([(0, 10)], []) == [(0, 10)]
    assert minus([(0, 10)], [(2, 4), (6, 8)]) == [(0, 2), (4, 6), (8, 10)]
    assert minus([(0, 10), (20, 30)], [(5, 25)]) == [(0, 5), (25, 30)]
    assert minus([(0, 10)], [(0, 10)]) == []
    assert minus([(5, 10)], [(0, 6), (9, 12)]) == [(6, 9)]
    assert minus([(0, 4), (6, 9)], [(4, 6)]) == [(0, 4), (6, 9)]


@pytest.mark.parametrize("name,scope", sorted(SYNC.items()))
def test_round_span_readers(name, scope):
    # two ranges of the span: kernels starting inside count, cut at the
    # range's end; one outside does not
    tr = _Fake([(0, 100 * MS, "a"), (150 * MS, 260 * MS, "b"),
                (300 * MS, 400 * MS, "c")],
               {scope: [(0, 120 * MS), (140 * MS, 250 * MS)]})
    assert abs(_read(name, _ctx(tr, "round")) - 1e3 * 0.2 / 10) < 1e-9
    assert _read(name, _ctx(tr, "lm_round")) is None
    assert _read(name, _ctx(_Fake(tr.device, {}), "round")) is None


@pytest.mark.parametrize("name,scope", sorted(LM.items()))
def test_lm_span_readers(name, scope):
    tr = _Fake([(0, 100 * MS, "a"), (500 * MS, 550 * MS, "b")],
               {scope: [(0, 600 * MS)]})
    assert abs(_read(name, _ctx(tr, "lm_round", 5)) - 150 / 5) < 1e-9
    assert _read(name, _ctx(tr, "round", 5)) is None
    assert _read(name, _ctx(_Fake(tr.device, {}), "lm_round", 5)) is None


def test_experts_without_the_recomputed_attention():
    """A layer's remat recompute, its attention core included, runs inside
    the experts' backward range: the attention's ranges come out of the
    experts' time, and the three layers add up to no more than busy."""
    device = [(0, 100 * MS, "expert fwd"),
              (250 * MS, 350 * MS, "attention recompute"),
              (400 * MS, 450 * MS, "norm recompute"),
              (500 * MS, 700 * MS, "expert bwd"),
              (720 * MS, 800 * MS, "attention bwd"),
              (850 * MS, 900 * MS, "sgd")]
    scopes = {"moe/experts": [(0, 100 * MS), (200 * MS, 700 * MS)],
              "attention/core": [(250 * MS, 350 * MS), (720 * MS, 800 * MS)],
              "lm_train/update": [(850 * MS, 900 * MS)]}
    tr = _Fake(device, scopes)
    ctx = _ctx(tr, "lm_round", 1)
    moe = _read("moe_ms.lm_round", ctx)
    attn = _read("attention_ms.lm_round", ctx)
    upd = _read("update_ms.lm_round", ctx)
    assert abs(moe - 350) < 1e-9 and abs(attn - 180) < 1e-9
    assert abs(upd - 50) < 1e-9
    busy_ms = sum(e - s for s, e in tr.busy) / MS
    assert moe + attn + upd <= busy_ms
    assert abs(device_ms(ctx, "moe/experts", "lm_round") - 450) < 1e-9


def test_host_read_reader():
    host = {1: [(-50 * MS, 30 * MS, "host_read/recluster"),
                (100 * MS, 120 * MS, "host_read/fetch"),
                (100 * MS, 110 * MS, "cudaStreamSynchronize"),
                (200 * MS, 300 * MS, "fed_step/aggregate")],
            2: [(990 * MS, 1100 * MS, "host_read/window")]}
    tr = _Fake([], {}, host)
    # clipped to the window: 30 + 20 + 10 ms over 4 rounds
    assert abs(_read("host_read_ms.round", _ctx(tr, "round", 4))
               - 60 / 4) < 1e-9
    assert _read("host_read_ms.round", _ctx(tr, "lm_round", 4)) is None
    assert _read("host_read_ms.round",
                 _ctx(_Fake([], {}, {1: host[1][2:]}), "round")) is None
    assert abs(host_ms(_ctx(tr, "round", 1), "host_read/fetch", "round")
               - 20) < 1e-9


def test_each_reader_in_its_one_cell():
    man = manifest.manifest()
    entries = {m["name"]: m for m in man["per_layer"]}
    for name, cell in [(n, "fedhc-lenet-n800-sync") for n in SYNC] + \
            [("host_read_ms.round", "fedhc-lenet-n800-sync")] + \
            [(n, "mixtral-8x22b-fl-c2") for n in LM]:
        m = entries[name]
        assert m["source"] == "program_span" and m["unit"] == "ms"
        assert m["workloads"] == [cell]
        assert m["moves"] == ("round_s" if cell.startswith("fedhc")
                              else "lm_round_s")
    assert manifest.validate(man) == []


def test_traced_cpu_run_reads_the_host_reads():
    """The live program on the CPU: its host reads are read; a CPU
    capture has no device ranges, so the device readers are silent."""
    import run
    import small
    out = run.run_cell("fedhc-lenet-n800-sync", 2 ** 33 + 7, 0.5, True,
                       device="cpu", cell_patch=small.small_sync)
    assert out["correct"]
    assert out["metrics"]["host_read_ms.round"]["value"] > 0
    assert not set(SYNC) & set(out["metrics"])


@pytest.mark.cuda
def test_experts_span_holds_its_backward_on_the_card(cuda_card):
    """A traced smoke Mixtral microbatch: the ``moe/experts`` device time
    of forward and backward is more than twice that of the forward alone
    (the backward, the layer's recompute and the experts' own recompute
    run on the autograd engine's thread, inside the span's backward
    range), and the attention core's likewise."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.tree import tree_leaves, tree_unflatten

    cfg = configs.smoke_variant(configs.get_config("mixtral-8x22b"))
    p = M.init_params(cfg, torch.Generator().manual_seed(0))
    p = tree_unflatten(p, [x.to(cuda_card) for x in tree_leaves(p)])
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(p)]
    toks = torch.randint(0, cfg.vocab_size, (2, 96), device=cuda_card)

    def loss():
        return M.loss_fn(cfg, tree_unflatten(p, leaves),
                         {"tokens": toks, "labels": toks},
                         dispatch="scan", remat=True)[0]

    def traced(fn):
        loss()                                   # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function(WINDOW):
                fn()
                torch.cuda.synchronize()
        return _ctx(Trace(prof), "lm_round", 1)

    fwd = traced(loss)
    both = traced(lambda: torch.autograd.grad(loss(), leaves))
    for name in LM:
        if name == "update_ms.lm_round":
            continue
        assert _read(name, both) > 2 * _read(name, fwd), name
