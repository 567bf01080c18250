"""Print one rank's counted collective bytes of the port's mesh program
beside the reference's ``collective_bytes`` of the same bundles compiled
on the same (2, 2) mesh, with their ratio: the smoke gemma2-2b (2 clients
of TP 2) and granite-3-8b (one client, FSDP over "data", TP 2), then the
smoke grok-1-314b and mixtral-8x22b (one client, FSDP over "data",
per-expert TP 2, the scan dispatch), whisper-large-v3 (2 clients of TP 2:
the encoder, the cross-attention) and pixtral-12b (one client, FSDP,
TP 2: the patch projection), f32, the train, prefill and decode bundles
of ``tests/test_torch_tp.py`` (pixtral's train and prefill sequences
48 and 80 + 32 positions: its 32 patches lead them).  GSPMD picks its own
schedule, so the two need not agree; the port's count equals a hand count
(``test_torch_tp.py``, ``test_torch_tp_families.py::
test_*_collective_bytes_equal_a_hand_count``).  XLA's HLO counts the body
of a loop once: the reference's scan over the layer cycles, its
accumulation scan over the microbatches and the MoE scan over the
experts, so its train bytes, and every MoE bundle's, are no yardstick.

    PYTHONPATH=src:tests python tests/tp_collectives.py
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import dataclasses  # noqa: E402
import json  # noqa: E402

import jax  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro.configs import get_config, get_profile, smoke_variant  # noqa
from repro.configs.shapes import InputShape  # noqa: E402
from repro.launch import hlo_analysis as jhlo  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import hlo_analysis as H  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402

import test_torch_tp as T  # noqa: E402

ARCHS = T.MEMORY_ARCHS + ("grok-1-314b", "mixtral-8x22b",
                          "whisper-large-v3", "pixtral-12b")


def shapes(arch: str) -> dict:
    """mode -> (sequence, batch): ``test_torch_tp.py``'s, pixtral's
    sequences longer by its 32 patches where they hold them."""
    out = dict(T.MEMORY_SHAPES)
    if arch == "pixtral-12b":
        out["train"] = (48, out["train"][1])
        out["prefill"] = (out["prefill"][0] + 32, out["prefill"][1])
        out["decode"] = (out["decode"][0] + 32, out["decode"][1])
    return out


def port(arch: str, mode: str, seq: int, batch: int) -> dict:
    """Rank 0's counted collectives of a bundle on a fake (2, 2) mesh."""
    from torch.distributed.device_mesh import init_device_mesh
    _, tcfg = T._cfgs(arch, {})
    with H.fake_process_group(4):
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data",
                                                               "model"))
        kw = {"num_clusters": 1} if mode == "train" else {}
        b = tsteps.build_step(arch, InputShape("s", seq, batch, mode), mesh,
                              cfg=tcfg, profile=T._profile(arch), **kw)
        n = 2 if mode == "train" else len(b.in_specs)
        args = dryrun._local_specs(b.in_specs[:n], b.in_shardings[:n],
                                   [2, 2])
        if mode == "train":
            c = H.count(b.fn, args + (0,), device="meta", trips=True)
        else:
            c = H.count(b.fn, args, device="meta")
    assert not dist.is_initialized()
    return c


def reference(arch: str, mode: str, seq: int, batch: int) -> dict:
    cfg = smoke_variant(get_config(arch))
    prof = dataclasses.replace(get_profile(arch), param_dtype="float32")
    jsteps.get_config = lambda a: cfg
    jsteps.get_profile = lambda a: prof
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
    for arch in ARCHS:
        for mode, (seq, batch) in shapes(arch).items():
            c = port(arch, mode, seq, batch)
            mine = H.collective_bytes(c)
            ref = reference(arch, mode, seq, batch)
            print(json.dumps({
                "arch": arch, "mode": mode, "mesh": "(2, 2)",
                "shape": (seq, batch), "port": mine,
                "port_by_axis": H.collectives_by_axis(c),
                "reference": ref,
                "port_over_reference": (mine["total"] / ref["total"]
                                        if ref.get("total") else None)}),
                flush=True)


if __name__ == "__main__":
    main()
