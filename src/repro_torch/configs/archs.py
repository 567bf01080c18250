"""The 10 assigned architectures (exact assigned hyper-parameters).

Every config cites its source.  ``REGISTRY[name]`` / ``get_config(name)``
return the full-size config; ``smoke_variant`` (configs.base) gives the
reduced CPU-testable variant of the same family.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig

# hd = d_model//heads unless the model card says otherwise.

GEMMA2_2B = ModelConfig(
    name="gemma2-2b", family="dense",
    num_layers=26, d_model=2304, num_heads=8, num_kv_heads=4, head_dim=256,
    d_ff=9216, vocab_size=256000,
    layer_pattern=("local", "global"), window_size=4096,
    attn_softcap=50.0, final_softcap=30.0, post_norm=True,
    act="gelu", rope_theta=10000.0, tie_embeddings=True,
    citation="arXiv:2408.00118 (Gemma 2)",
)

GROK1_314B = ModelConfig(
    name="grok-1-314b", family="moe",
    num_layers=64, d_model=6144, num_heads=48, num_kv_heads=8, head_dim=128,
    d_ff=32768, vocab_size=131072,
    num_experts=8, experts_per_token=2,
    act="gelu", rope_theta=10000.0, tie_embeddings=True,
    citation="hf:xai-org/grok-1",
)

H2O_DANUBE_18B = ModelConfig(
    name="h2o-danube-1.8b", family="dense",
    num_layers=24, d_model=2560, num_heads=32, num_kv_heads=8, head_dim=80,
    d_ff=6912, vocab_size=32000,
    layer_pattern=("swa",), window_size=4096,
    act="silu", rope_theta=10000.0, tie_embeddings=False,
    citation="arXiv:2401.16818 (H2O-Danube: llama+mistral mix, SWA)",
)

GRANITE3_8B = ModelConfig(
    name="granite-3-8b", family="dense",
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=12800, vocab_size=49155,
    act="silu", rope_theta=10000.0, tie_embeddings=True,
    citation="hf:ibm-granite/granite-3.0-2b-base (granite-3 8B cfg)",
)

WHISPER_LARGE_V3 = ModelConfig(
    name="whisper-large-v3", family="audio",
    num_layers=32, d_model=1280, num_heads=20, num_kv_heads=20, head_dim=64,
    d_ff=5120, vocab_size=51866,
    encoder_layers=32, frontend="audio", frontend_len=1500,
    norm="layernorm", act="gelu", tie_embeddings=True,
    citation="arXiv:2212.04356 (Whisper; conv/mel frontend stubbed)",
)

PIXTRAL_12B = ModelConfig(
    name="pixtral-12b", family="vlm",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=131072,
    frontend="vision", frontend_len=1024,
    act="silu", rope_theta=1000000.0, tie_embeddings=True,
    citation="hf:mistralai/Pixtral-12B-2409 (ViT tower stubbed)",
)

RECURRENTGEMMA_2B = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    num_layers=26, d_model=2560, num_heads=10, num_kv_heads=1, head_dim=256,
    d_ff=7680, vocab_size=256000,
    layer_pattern=("rglru", "rglru", "local"), window_size=2048,
    lru_width=2560, act="gelu", tie_embeddings=True,
    citation="arXiv:2402.19427 (Griffin / RecurrentGemma, RG-LRU 2:1 local)",
)

QWEN2_72B = ModelConfig(
    name="qwen2-72b", family="dense",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=29568, vocab_size=152064,
    qkv_bias=True, act="silu", rope_theta=1000000.0, tie_embeddings=False,
    citation="arXiv:2407.10671 (Qwen2; GQA, QKV bias)",
)

MIXTRAL_8X22B = ModelConfig(
    name="mixtral-8x22b", family="moe",
    num_layers=56, d_model=6144, num_heads=48, num_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=32768,
    num_experts=8, experts_per_token=2,
    layer_pattern=("swa",), window_size=4096,
    act="silu", rope_theta=1000000.0, tie_embeddings=False,
    citation="arXiv:2401.04088 (Mixtral; 8e top-2, SWA)",
)

MAMBA2_13B = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    num_layers=48, d_model=2048, num_heads=0, num_kv_heads=0, head_dim=0,
    d_ff=0, vocab_size=50280,
    layer_pattern=("ssd",), ssm_state=128, ssm_expand=2, ssm_head_dim=64,
    ssm_conv=4, ssm_chunk=256,
    act="silu", tie_embeddings=True,
    citation="arXiv:2405.21060 (Mamba-2 SSD)",
)

REGISTRY = {c.name: c for c in (
    GEMMA2_2B, GROK1_314B, H2O_DANUBE_18B, GRANITE3_8B, WHISPER_LARGE_V3,
    PIXTRAL_12B, RECURRENTGEMMA_2B, QWEN2_72B, MIXTRAL_8X22B, MAMBA2_13B,
)}

ARCH_NAMES = tuple(REGISTRY)

# Architectures too large for one-replica-per-data-index FL placement:
# one FL client = one pod slice (the reference's placement).
POD_CLIENT_ARCHS = {"grok-1-314b", "qwen2-72b", "mixtral-8x22b", "pixtral-12b",
                    "granite-3-8b"}


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]
