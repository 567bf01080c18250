"""Arch config module: mixtral-8x22b, selectable via --arch mixtral-8x22b."""
from repro_torch.configs.archs import REGISTRY
from repro_torch.configs.runtime import RunProfile

CONFIG = REGISTRY["mixtral-8x22b"]
PROFILE = RunProfile(arch="mixtral-8x22b", client_axis="pod", grad_accum=32,
                     moe_dispatch="scan", accum_dtype="bfloat16")
