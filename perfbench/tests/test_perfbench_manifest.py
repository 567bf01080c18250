"""BENCHMARK.json and the files it names keep the benchmark's contract."""
import ast
import json

import pytest

from pb import manifest

MAN = manifest.manifest()
CELLS = [w["name"] for w in MAN["workloads"]]
WIDTHS = ("d_model", "d_ff", "head_dim", "num_heads", "num_kv_heads",
          "experts_per_token", "hidden_size", "intermediate_size")


def test_manifest_is_valid():
    assert manifest.validate(MAN) == []


@pytest.mark.parametrize("bad", [
    {"name": "a b"}, {"name": "x/y"}, {"unit": "tokens per s"},
    {"better": "up"}, {"source": "guess"}, {"bound": 0.5},
    {"extra": 1},
])
def test_validate_refuses(bad):
    m = json.loads(json.dumps(MAN))
    m["end_to_end"][0].update(bad)
    assert manifest.validate(m)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files(cell):
    entry = {w["name"]: w for w in MAN["workloads"]}[cell]
    f = manifest.cell_file(cell)
    assert f["name"] == cell and f["config"] == entry["config"]
    assert f["chips"] == entry["chips"]
    assert f["traffic"]["name"] == entry["traffic"]
    assert (manifest.BENCH_DIR / "drivers" / f"{f['driver']}.py").is_file()
    assert f["limits"] and all(v >= 0 for v in f["limits"].values())


@pytest.mark.parametrize("config", [c["name"] for c in MAN["configs"]])
def test_config_files(config):
    entry = {c["name"]: c for c in MAN["configs"]}[config]
    f = manifest.load_json(manifest.ROOT / entry["file"])
    assert f["name"] == config
    assert sorted(f["reduced"]) == sorted(entry["reduced"])
    assert not any(k in WIDTHS or k.endswith(("_dim", "_rank"))
                   for k in entry["reduced"])
    for k in entry["reduced"]:          # each cut states its published size
        assert k in f.get("published", {}), k


@pytest.mark.parametrize("metric", [m["name"] for m in MAN["per_layer"]])
def test_metric_readers(metric):
    mod = manifest.load_module("metrics", metric)
    assert callable(mod.read)


def test_no_jax_anywhere():
    """Nothing under perfbench/ imports jax, jaxlib, flax or the JAX
    package (top-level names compared whole: repro_torch is not repro);
    the references import nothing of the program."""
    for path in manifest.BENCH_DIR.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "flax", "repro"), \
                    (path, n)
                if path.parent.name == "reference":
                    assert top != "repro_torch", (path, n)


def test_forbidden_modules_are_whole_names():
    import run
    assert "repro_torch" not in run.FORBIDDEN
    assert all(m.split(".")[0] not in run.FORBIDDEN
               for m in ("repro_torch", "repro_torch.core", "jaxtyping"))


def test_a_module_loaded_by_the_check_withholds_the_result(monkeypatch,
                                                           capsys):
    """The look for JAX comes after the check: a forbidden module that
    the reference or the comparison loads stops the run before a result
    is printed."""
    import sys
    import types

    import run
    import small
    real = manifest.load_module

    def load(kind, name):
        mod = real(kind, name)
        if kind == "drivers":
            check = mod.Driver.check

            def check_and_load(self):
                monkeypatch.setitem(sys.modules, "jax",
                                    types.ModuleType("jax"))
                return check(self)
            mod.Driver.check = check_and_load
        return mod
    monkeypatch.setattr(manifest, "load_module", load)
    with pytest.raises(SystemExit) as stop:
        run.run_cell("fedhc-lenet-n800-sync", 2 ** 31 + 9, 0.2, False,
                     device="cpu", cell_patch=small.small_sync)
    assert stop.value.code != 0
    out = capsys.readouterr()
    assert "jax" in out.err and '"correct"' not in out.out
