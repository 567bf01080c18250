"""A whole run of each cell, the chip's look skipped, with the timed path
broken underneath: ``correct`` has to come out false for each fault the
cell can have.  (No cell spans chips, so there is no exchange between
chips to leave out.)"""
import pytest

import faults
import run
import small


def _run(cell, patch):
    return run.run_cell(cell, 2 ** 32 + 17, 0.2, False, device="cpu",
                        cell_patch=patch)


@pytest.mark.parametrize("fault", faults.SYNC, ids=lambda f: f.__name__)
def test_sync_cell_catches(fault, monkeypatch):
    fault(monkeypatch)
    out = _run("fedhc-lenet-n800-sync", small.small_sync)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("fault", faults.TRAIN, ids=lambda f: f.__name__)
def test_moe_cell_catches(fault, monkeypatch):
    fault(monkeypatch)
    out = _run("mixtral-8x22b-fl-c2", small.small_moe)
    assert out["correct"] is False, out["checks"]


def test_moe_control_is_refused():
    """The float8 control in the program's place fails the cell's limits
    (the LeNet cell's TF32 control exists only on the card: below)."""
    import calibrate
    r = calibrate.readings("mixtral-8x22b-fl-c2", 5, True, device="cpu",
                           cell_patch=small.small_moe)
    from pb import manifest
    limits = manifest.cell_file("mixtral-8x22b-fl-c2")["limits"]
    assert any(v > limits[k] for k, v in r["control"].items()), r


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["fedhc-lenet-n800-sync"])
def test_lenet_control_is_refused_on_the_card(cell, cuda_card):
    """The TF32 control in the program's place fails the LeNet cell's
    limits (TF32 exists only on the card), at the cell's own size."""
    import calibrate
    from pb import manifest

    def first_run(c, config):
        c["traffic"].update(check_among=1)
    r = calibrate.readings(cell, 3, True, cell_patch=first_run)
    limits = manifest.cell_file(cell)["limits"]
    assert all(v <= limits[k] for k, v in r["program"].items()), r
    assert any(v > limits[k] for k, v in r["control"].items()), r
