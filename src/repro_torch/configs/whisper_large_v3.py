"""Arch config module: whisper-large-v3, selectable via --arch whisper-large-v3."""
from repro_torch.configs.archs import REGISTRY
from repro_torch.configs.runtime import RunProfile

CONFIG = REGISTRY["whisper-large-v3"]
PROFILE = RunProfile(arch="whisper-large-v3", client_axis="data", grad_accum=8,
                     moe_dispatch="dense")
