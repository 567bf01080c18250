"""Arch config module: mamba2-1.3b, selectable via --arch mamba2-1.3b."""
from repro_torch.configs.archs import REGISTRY
from repro_torch.configs.runtime import RunProfile

CONFIG = REGISTRY["mamba2-1.3b"]
PROFILE = RunProfile(arch="mamba2-1.3b", client_axis="data", grad_accum=8,
                     moe_dispatch="dense")
