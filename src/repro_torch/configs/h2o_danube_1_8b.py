"""Arch config module: h2o-danube-1.8b, selectable via --arch h2o-danube-1.8b."""
from repro_torch.configs.archs import REGISTRY
from repro_torch.configs.runtime import RunProfile

CONFIG = REGISTRY["h2o-danube-1.8b"]
PROFILE = RunProfile(arch="h2o-danube-1.8b", client_axis="data", grad_accum=4,
                     moe_dispatch="dense")
