"""Arch config module: recurrentgemma-2b, selectable via --arch recurrentgemma-2b."""
from repro_torch.configs.archs import REGISTRY
from repro_torch.configs.runtime import RunProfile

CONFIG = REGISTRY["recurrentgemma-2b"]
PROFILE = RunProfile(arch="recurrentgemma-2b", client_axis="data", grad_accum=4,
                     moe_dispatch="dense")
