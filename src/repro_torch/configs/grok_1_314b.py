"""Arch config module: grok-1-314b, selectable via --arch grok-1-314b."""
from repro_torch.configs.archs import REGISTRY
from repro_torch.configs.runtime import RunProfile

CONFIG = REGISTRY["grok-1-314b"]
PROFILE = RunProfile(arch="grok-1-314b", client_axis="pod", grad_accum=64,
                     moe_dispatch="scan", kv_int8=True,
                     accum_dtype="bfloat16")
