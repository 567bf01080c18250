"""The reduction of a profiler capture and the per-layer readers."""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pb import manifest
from pb.trace import WINDOW, Trace, merge


def test_merge():
    assert merge([(5, 7), (0, 2), (1, 3), (6, 9)]) == [(0, 3), (5, 9)]


def _capture():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(WINDOW):
            with torch.profiler.record_function("scope/a"):
                x = torch.randn(200, 200)
                x @ x
    return prof


def test_cpu_capture_has_window_and_no_device_time():
    tr = Trace(_capture())
    assert tr.window_s > 0 and tr.busy_s == 0
    assert tr.device_ops() == []
    gaps = tr.idle_gaps()
    assert sum(s for _, s in gaps) == tr.window_s
    assert gaps[0][0] != "host: no operation"


class _Fake:
    """A trace of known device intervals (ns) in a 1 s window."""
    t0, t1 = 0, 1_000_000_000
    window_s = 1.0

    def __init__(self):
        self.device = [(0, 200_000_000, "gemm"),
                       (100_000_000, 300_000_000, "wagg_grouped_rows_kernel"),
                       (500_000_000, 600_000_000, "gemm")]
        self.busy = merge((s, e) for s, e, _ in self.device)
        self.device_scopes = {"fed_step/local_train": [(0, 250_000_000)]}
        self.host = {}

    busy_s = property(Trace.busy_s.fget)
    kernel_s = Trace.kernel_s
    scope_s = Trace.scope_s


def _read(name, unit="round", **layer):
    ctx = {"trace": _Fake(), "units": 10, "unit": unit, "layer": layer,
           "untraced": {"units": 20, "window_s": 1.6}}
    return manifest.load_module("metrics", name).read(ctx)


def test_readers_on_known_intervals():
    # 0.4 s busy over 10 units against 0.08 s of wall a unit
    assert abs(_read("device_idle_share.round") - 50.0) < 1e-9
    assert _read("device_idle_share.lm_round", unit="round") is None
    assert abs(_read("mfu.round", model_flops=67e12 * 0.4,
                     peak_flops=67e12) - 50.0) < 1e-9
    assert abs(_read("stage1_roofline.round", stage1_calls=10,
                     stage1_bound_s=0.01) - 50.0) < 1e-9
    # kernels inside the scope's device range: 0.2 s + 0.15 s of 0.25 s
    assert abs(_read("local_train_ms.round", scope="fed_step/local_train")
               - 1e3 * 0.35 / 10) < 1e-9


def test_capture_without_the_window_is_refused():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.randn(20, 20).sum()
    with pytest.raises(RuntimeError, match="perfbench/window"):
        Trace(prof)


@pytest.mark.parametrize("unit", ["round", "lm_round"])
def test_round_readers_read_their_own_unit(unit):
    """The LeNet round's readers and the transformer round's read the
    same arithmetic, each only in cells of its own unit."""
    other = "lm_round" if unit == "round" else "round"
    assert abs(_read(f"device_idle_share.{unit}", unit=unit) - 50.0) < 1e-9
    assert _read(f"device_idle_share.{unit}", unit=other) is None
    assert abs(_read(f"mfu.{unit}", unit=unit, model_flops=67e12 * 0.4,
                     peak_flops=67e12) - 50.0) < 1e-9
    assert _read(f"mfu.{unit}", unit=other, model_flops=1.0,
                 peak_flops=1.0) is None
    assert abs(_read(f"stage1_roofline.{unit}", unit=unit, stage1_calls=10,
                     stage1_bound_s=0.01) - 50.0) < 1e-9
    assert _read(f"stage1_roofline.{unit}", unit=other, stage1_calls=10,
                 stage1_bound_s=0.01) is None
