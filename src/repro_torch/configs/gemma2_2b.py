"""Arch config module: gemma2-2b, selectable via --arch gemma2-2b."""
from repro_torch.configs.archs import REGISTRY
from repro_torch.configs.runtime import RunProfile

CONFIG = REGISTRY["gemma2-2b"]
PROFILE = RunProfile(arch="gemma2-2b", client_axis="data", grad_accum=4,
                     moe_dispatch="dense")
