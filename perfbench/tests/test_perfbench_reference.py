"""Each plain reference against the program at sizes the CPU holds, and
whole runs of each cell there (the chip's look skipped)."""
import math

import pytest
import torch

import run
import small
from pb import manifest
from reference import fedhc as ref_fedhc
from reference import moe_lm as ref_lm
from traffic import lenet_fl, lm_tokens


def test_lenet_logits_and_gradients_match_the_program():
    from repro_torch.core import maml
    from repro_torch.models.lenet import lenet_forward, lenet_loss
    config = manifest.config_file("fedhc-lenet-mnist-n800")
    cpu = torch.device("cpu")
    inputs = lenet_fl.make_inputs(
        {**config, "fleet": {**config["fleet"], "num_clients": 4}}, 7, cpu)
    w = {n: {k: v[None].expand((4,) + v.shape).clone() for k, v in d.items()}
         for n, d in inputs["w0"].items()}
    imgs = inputs["images"][:4 * 8].reshape(4, 8, 28, 28, 1)
    labs = inputs["labels"][:32].reshape(4, 8)
    torch.testing.assert_close(ref_fedhc.logits(w, imgs),
                               lenet_forward(w, imgs), rtol=1e-5, atol=1e-5)
    lp, gp = maml.grad_tree(lenet_loss, w, (imgs, labs))
    lr, gr = ref_fedhc.grads(w, imgs, labs)
    torch.testing.assert_close(lr, lp, rtol=1e-6, atol=1e-6)
    for n in ref_fedhc.LEAVES:
        for k in ("w", "b"):
            torch.testing.assert_close(gr[n][k], gp[n][k], rtol=1e-5,
                                       atol=1e-6)


def test_moe_loss_matches_the_program():
    from repro_torch.configs import get_config
    from repro_torch.configs.base import depth_cut, smoke_variant
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    cell = manifest.cell_file("mixtral-8x22b-fl-c2")
    config = manifest.config_file("mixtral-8x22b-fl")
    small.small_moe(cell, config)
    m = config["model"]
    cfg = depth_cut(smoke_variant(get_config("mixtral-8x22b")), 1)
    cfg = steps.dataclasses.replace(cfg, dtype="float32")
    cpu = torch.device("cpu")
    w = lm_tokens.init_weights(m, 3, cpu, torch.float32)
    nest = manifest.load_module("drivers", "fl_train")._nest
    batch = lm_tokens.rows(config["fl"], m, 3, 0, cpu)
    b = {k: v[0, :2] for k, v in batch.items()}
    want = M.loss_fn(cfg, nest(w), b, dispatch="scan",
                     aux_weight=config["fl"]["aux_weight"])[0]
    got = ref_lm.loss_fn(m, config["fl"], w, b["tokens"], b["labels"])
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))


@pytest.mark.parametrize("cell,patch", [
    ("fedhc-lenet-n800-sync", small.small_sync),
    ("mixtral-8x22b-fl-c2", small.small_moe),
])
def test_cell_runs_and_is_correct(cell, patch):
    out = run.run_cell(cell, 2 ** 33 + 5, 0.5, False, device="cpu",
                       cell_patch=patch)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["attempted"] > 0
    man = manifest.manifest()
    want = {m["name"] for m in manifest.metrics_for(man, cell, "end_to_end")}
    assert set(out["metrics"]) == want
    assert all(math.isfinite(m["value"]) for m in out["metrics"].values())


def test_traced_run_on_the_cpu_reports_no_device_metric():
    out = run.run_cell("fedhc-lenet-n800-sync", 11, 0.5, True, device="cpu",
                       cell_patch=small.small_sync)
    assert out["correct"]
    assert out["device"]["busy_s"] == 0.0
    assert "mfu.round" not in out["metrics"]
    assert "device_idle_share.round" not in out["metrics"]
