"""The ``--mesh DxM`` launchers on the CPU: ``launch/serve.py`` and
``launch/train.py`` run their step on D x M spawned gloo ranks
(``launch/mesh.spawn_ranks``, each rank drawing the one-device model and
keeping its blocks through ``launch/mesh.local_blocks``), and rank 0's
JSON line meets the one-device run of the same command line.

* Serving (gemma2-2b, grok-1-314b, whisper-large-v3, mamba2-1.3b and
  recurrentgemma-2b smoke, float32, (1, 2)): rank 0 serves every row,
  and its greedy tokens equal the one-device run's.
* Training (gemma2-2b, mamba2-1.3b and recurrentgemma-2b smoke, bfloat16
  as their profiles, (2, 2): two clients of two model ranks, the clients
  set by the mesh): round 0's mean client CE meets the one-device run's
  with two clients at 1e-2 relative, the bar of
  ``tests/test_torch_train.py``'s bf16 round.
"""
import json

import pytest

from repro_torch.launch import serve, train

BF16_CE_RTOL = 1e-2


def _line(capfd, main, argv):
    """The last JSON line ``main(argv)`` prints (rank 0's on a mesh:
    spawned ranks write to the same file descriptor)."""
    capfd.readouterr()
    main(argv)
    out = capfd.readouterr().out
    return json.loads([s for s in out.splitlines() if s.startswith("{")][-1])


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    # each spawned rank inherits the environment: one thread a rank
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def test_serve_mesh_1x2_matches_one_device(capfd):
    argv = ["--arch", "gemma2-2b", "--smoke", "--device", "cpu",
            "--batch", "2", "--prompt-len", "24", "--tokens", "5"]
    one = _line(capfd, serve.main, argv)
    got = _line(capfd, serve.main, argv + ["--mesh", "1x2"])
    assert got["mesh"] == {"data": 1, "model": 2}
    assert got["rows"] == 2
    assert got["params"] == one["params"]
    assert got["first_tokens"] == one["first_tokens"]
    # the prefill's K/V gathers and the row-parallel all-reduces ran
    assert got["collective_bytes"]["model"]["all-reduce"] > 0


@pytest.mark.parametrize("arch", ["grok-1-314b", "whisper-large-v3"])
def test_serve_mesh_1x2_new_families_match_one_device(capfd, arch):
    """grok-1-314b (per-expert TP, scan dispatch, int8 cache) and
    whisper-large-v3 (frames drawn from ``--seed`` on every rank alike,
    encoded on the mesh; cross-attention on a rank's heads): rank 0's
    greedy tokens equal the one-device run's."""
    argv = ["--arch", arch, "--smoke", "--device", "cpu",
            "--batch", "2", "--prompt-len", "24", "--tokens", "5"]
    one = _line(capfd, serve.main, argv)
    got = _line(capfd, serve.main, argv + ["--mesh", "1x2"])
    assert got["mesh"] == {"data": 1, "model": 2}
    assert got["params"] == one["params"]
    assert got["first_tokens"] == one["first_tokens"]
    assert got["collective_bytes"]["model"]["all-reduce"] > 0
    if arch == "grok-1-314b":           # the routing agreed over "model"
        assert got["collective_bytes"]["model"]["broadcast"] > 0
    else:
        assert got["encode_s"] > 0


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-2b"])
def test_serve_mesh_1x2_recurrent_pair_matches_one_device(capfd, arch):
    """mamba2-1.3b (the SSD by heads: its all-reduces alone) and
    recurrentgemma-2b (the RG-LRU by channels, its conv output gathered
    over "model"; the local layers' K/V gathered): rank 0's greedy
    tokens equal the one-device run's."""
    argv = ["--arch", arch, "--smoke", "--device", "cpu",
            "--batch", "2", "--prompt-len", "24", "--tokens", "5"]
    one = _line(capfd, serve.main, argv)
    got = _line(capfd, serve.main, argv + ["--mesh", "1x2"])
    assert got["mesh"] == {"data": 1, "model": 2}
    assert got["params"] == one["params"]
    assert got["first_tokens"] == one["first_tokens"]
    kinds = got["collective_bytes"]["model"]
    assert kinds["all-reduce"] > 0
    assert ("all-gather" in kinds) == (arch == "recurrentgemma-2b")


def test_train_mesh_2x2_matches_one_device(capfd):
    _train_2x2(capfd, "gemma2-2b")


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-2b"])
def test_train_mesh_2x2_recurrent_pair_matches_one_device(capfd, arch):
    _train_2x2(capfd, arch)


def _train_2x2(capfd, arch):
    argv = ["--arch", arch, "--smoke", "--device", "cpu",
            "--rounds", "1", "--global-batch", "4", "--clusters", "2"]
    one = _line(capfd, train.main, argv + ["--clients", "2"])
    got = _line(capfd, train.main, argv + ["--mesh", "2x2"])
    assert got["mesh"] == {"data": 2, "model": 2}
    assert got["clients"] == one["clients"] == 2
    assert got["clusters"] == one["clusters"]
    ce, want = got["rounds"][0]["ce"], one["rounds"][0]["ce"]
    assert abs(ce - want) <= BF16_CE_RTOL * abs(want), (ce, want)
    assert got["rounds"][0]["collective_bytes"]["model"]["all-reduce"] > 0
