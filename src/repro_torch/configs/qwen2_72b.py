"""Arch config module: qwen2-72b, selectable via --arch qwen2-72b."""
from repro_torch.configs.archs import REGISTRY
from repro_torch.configs.runtime import RunProfile

CONFIG = REGISTRY["qwen2-72b"]
PROFILE = RunProfile(arch="qwen2-72b", client_axis="pod", grad_accum=64,
                     moe_dispatch="dense", kv_int8=True)
