"""Arch config module: pixtral-12b, selectable via --arch pixtral-12b."""
from repro_torch.configs.archs import REGISTRY
from repro_torch.configs.runtime import RunProfile

CONFIG = REGISTRY["pixtral-12b"]
PROFILE = RunProfile(arch="pixtral-12b", client_axis="pod", grad_accum=16,
                     moe_dispatch="dense")
