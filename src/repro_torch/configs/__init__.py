"""Model configurations: the port's copy of ``repro/configs`` (data only).

``RunProfile`` and ``get_profile`` come with the launch slice.
"""
from repro_torch.configs.archs import ARCH_NAMES, REGISTRY, get_config
from repro_torch.configs.base import (ATTN_KINDS, ModelConfig, replace,
                                      smoke_variant)
from repro_torch.configs.shapes import SHAPES, InputShape, effective_cache_len
