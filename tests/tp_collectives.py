"""Print one rank's counted collective bytes of the dense transformers'
mesh program beside the reference's ``collective_bytes`` of the same
bundles compiled on the same (2, 2) mesh, with their ratio: the smoke
gemma2-2b (2 clients of TP 2) and granite-3-8b (one client, FSDP over
"data", TP 2), f32, the train, prefill and decode bundles of
``tests/test_torch_tp.py``.  GSPMD picks its own schedule, so the two
need not agree; the port's count equals a hand count
(``test_torch_tp.py::test_*_collective_bytes_equal_a_hand_count``).

    PYTHONPATH=src:tests python tests/tp_collectives.py
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import dataclasses  # noqa: E402
import json  # noqa: E402

import jax  # noqa: E402

from repro.configs import get_config, get_profile, smoke_variant  # noqa
from repro.configs.shapes import InputShape  # noqa: E402
from repro.launch import hlo_analysis as jhlo  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.launch import hlo_analysis as H  # noqa: E402

import test_torch_tp as T  # noqa: E402


def reference(arch: str, mode: str) -> dict:
    cfg = smoke_variant(get_config(arch))
    prof = dataclasses.replace(get_profile(arch), param_dtype="float32")
    jsteps.get_config = lambda a: cfg
    jsteps.get_profile = lambda a: prof
    seq, batch = T.MEMORY_SHAPES[mode]
    mesh = make_test_mesh((2, 2))
    with mesh:
        kw = {"num_clusters": 1} if mode == "train" else {}
        b = jsteps.build_step(arch, InputShape("s", seq, batch, mode), mesh,
                              **kw)
        donate = {"train": (0,), "decode": (1,)}.get(mode, ())
        compiled = jax.jit(b.fn, in_shardings=b.in_shardings,
                           out_shardings=b.out_shardings,
                           donate_argnums=donate).lower(*b.in_specs).compile()
    return jhlo.collective_bytes(compiled.as_text())


def main() -> None:
    for arch in T.MEMORY_ARCHS:
        for mode in T.MEMORY_SHAPES:
            _, c = T._port_memory(arch, mode)
            port = H.collective_bytes(c)
            ref = reference(arch, mode)
            print(json.dumps({
                "arch": arch, "mode": mode, "mesh": "(2, 2)",
                "shape": T.MEMORY_SHAPES[mode], "port": port,
                "port_by_axis": H.collectives_by_axis(c),
                "reference": ref,
                "port_over_reference": (port["total"] / ref["total"]
                                        if ref.get("total") else None)}))


if __name__ == "__main__":
    main()
