"""Model configurations: the port's copy of ``repro/configs`` (data only),
with the per-arch runtime profiles (``get_profile``)."""
import importlib

from repro_torch.configs.archs import (ARCH_NAMES, POD_CLIENT_ARCHS, REGISTRY,
                                       get_config)
from repro_torch.configs.base import (ATTN_KINDS, FLConfig, ModelConfig,
                                      TrainConfig, depth_cut, replace,
                                      smoke_variant)
from repro_torch.configs.runtime import RunProfile
from repro_torch.configs.shapes import (SHAPES, InputShape,
                                        effective_cache_len, shape_applicable)

_PROFILE_MODULES = {
    "gemma2-2b": "gemma2_2b", "grok-1-314b": "grok_1_314b",
    "h2o-danube-1.8b": "h2o_danube_1_8b", "granite-3-8b": "granite_3_8b",
    "whisper-large-v3": "whisper_large_v3", "pixtral-12b": "pixtral_12b",
    "recurrentgemma-2b": "recurrentgemma_2b", "qwen2-72b": "qwen2_72b",
    "mixtral-8x22b": "mixtral_8x22b", "mamba2-1.3b": "mamba2_1_3b",
}


def get_profile(name: str) -> RunProfile:
    mod = importlib.import_module(
        f"repro_torch.configs.{_PROFILE_MODULES[name]}")
    return mod.PROFILE
