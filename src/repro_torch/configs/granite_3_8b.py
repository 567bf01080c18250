"""Arch config module: granite-3-8b, selectable via --arch granite-3-8b."""
from repro_torch.configs.archs import REGISTRY
from repro_torch.configs.runtime import RunProfile

CONFIG = REGISTRY["granite-3-8b"]
PROFILE = RunProfile(arch="granite-3-8b", client_axis="pod", grad_accum=16,
                     moe_dispatch="dense")
