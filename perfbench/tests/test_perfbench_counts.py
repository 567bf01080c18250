"""The FLOP and byte counts against hand-worked values."""
import pytest

from counts import lenet, moe_lm, stage1
from pb import manifest, peaks

LENET = manifest.config_file("fedhc-lenet-mnist-n800")
MIXTRAL = manifest.config_file("mixtral-8x22b-fl")


def test_lenet_forward_flops():
    # conv1 24*24*6*25, conv2 8*8*16*150, dense 256*120 + 120*84 + 84*10
    macs = 86_400 + 153_600 + 30_720 + 10_080 + 840
    assert lenet.forward_flops(LENET["dataset"], LENET["model"]) \
        == 2 * macs == 563_280


def test_lenet_params():
    assert lenet.params(LENET["dataset"], LENET["model"]) == 44_426


def test_lenet_round_flops():
    # 800 clients x 2 steps x 64 samples x 3 forwards
    got = lenet.run_flops(LENET, rounds=1, reclusters=0, evals=0,
                          clients=800)
    assert got == 800 * 2 * 64 * 3 * 563_280
    assert got / 0.0635 / peaks.FLOPS["float32"] == pytest.approx(
        0.0407, rel=0.01)


def test_mixtral_active_params():
    assert moe_lm.active_matmul_params(MIXTRAL["model"]) == 893_435_904


def test_mixtral_total_params():
    # the stage-1 columns of one client, as the card's run counted them
    assert moe_lm.total_params(MIXTRAL["model"]) == 2_906_720_256


def test_mixtral_round_flops():
    m = MIXTRAL["model"]
    pairs = 4096 * 4097 // 2          # window 4096 covers the sequence
    assert moe_lm.attended_pairs(4096, 4096) == pairs
    assert moe_lm.attended_pairs(8, 3) == 1 + 2 + 3 * 6
    fwd = 2 * 893_435_904 * 4096 + 48 * pairs * 128 * 4
    assert moe_lm.forward_flops(m, 4096) == fwd
    got = moe_lm.train_flops(m, 4096, 16)
    assert got == 3 * 16 * fwd
    assert got == pytest.approx(3.61e14, rel=0.01)


def test_stage1_bound():
    # C = 800, P = 44,426, K = 4, float32: 142.9 MB at 3.35 TB/s
    assert stage1.bytes_moved(800, 44_426, 4, 4) \
        == 800 * 44_426 * 4 + 800 * 4 * 4 + 4 * 44_426 * 4
    assert stage1.bound_s(800, 44_426, 4, 4) * 1e3 == pytest.approx(
        0.0427, abs=5e-5)
    # the Mixtral layer's stage-1: 17.44 GB, 5.206 ms
    assert stage1.bound_s(2, 2_906_720_256, 1, 2) * 1e3 == pytest.approx(
        5.206, abs=5e-3)
