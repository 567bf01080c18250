"""Model configuration: the port's own copy of ``repro/configs/base.py``.

``ModelConfig`` describes one transformer-family architecture (dense, MoE,
SSM, hybrid, audio enc-dec, VLM backbone); the values and properties are
the reference's, field for field, so a config means the same model in both
packages.  ``smoke_variant`` gives the reduced CPU-testable variant.
``FLConfig`` (the FedHC topology and schedule) and ``TrainConfig`` (the
local optimizer) are the reference's too, field for field.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# Layer kinds used in ``ModelConfig.layer_pattern`` (cycled over depth):
#   "attn"   - full causal self-attention
#   "swa"    - sliding-window causal self-attention (window_size)
#   "local"  - alias of swa (gemma2 terminology)
#   "global" - full attention (gemma2 terminology)
#   "rglru"  - RecurrentGemma RG-LRU recurrent block
#   "ssd"    - Mamba-2 state-space-duality block
LAYER_KINDS = ("attn", "swa", "local", "global", "rglru", "ssd")

ATTN_KINDS = ("attn", "swa", "local", "global")


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description.  One instance per assigned architecture."""

    name: str
    family: str                       # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- attention details -------------------------------------------------
    layer_pattern: Tuple[str, ...] = ("attn",)
    window_size: int = 4096           # for swa/local layers
    attn_softcap: float = 0.0         # gemma2: 50.0 (0 = disabled)
    final_softcap: float = 0.0        # gemma2: 30.0 (0 = disabled)
    qkv_bias: bool = False            # qwen2: True
    rope_theta: float = 10000.0

    # --- MoE ----------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0

    # --- SSM (Mamba-2 SSD) ---------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256              # SSD chunk length

    # --- RG-LRU (RecurrentGemma) ----------------------------------------------
    lru_width: int = 0                # 0 => d_model

    # --- encoder-decoder / modality frontend -----------------------------------
    encoder_layers: int = 0           # >0 => enc-dec (whisper)
    frontend: str = "none"            # none | audio | vision
    frontend_len: int = 0             # precomputed frame/patch count per example

    # --- misc -------------------------------------------------------------------
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    act: str = "silu"                 # silu | gelu
    post_norm: bool = False           # gemma2: pre+post block norms
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    citation: str = ""

    # ------------------------------------------------------------------
    @property
    def vocab_padded(self) -> int:
        """Vocab padded to a multiple of 256 so the unembed projection and
        logits shard cleanly over a 16-way model axis (production vocab
        padding; padded logits are masked to -inf in the loss)."""
        return (self.vocab_size + 255) // 256 * 256

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def is_enc_dec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def is_attention_free(self) -> bool:
        return all(k == "ssd" for k in self.layer_pattern)

    @property
    def d_inner(self) -> int:
        """Mamba-2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_head_dim else 0

    @property
    def sub_quadratic(self) -> bool:
        """True when every layer has bounded attention state (window or
        recurrent), i.e. the arch can serve ``long_500k``.

        gemma2 is handled specially in shapes.py: its local layers are
        windowed but its global layers keep a full cache; we still run
        long_500k for it (linear per decoded token, cache sharded)."""
        return all(k in ("swa", "local", "rglru", "ssd") for k in self.layer_pattern)

    def layer_kinds(self) -> Tuple[str, ...]:
        """The per-layer kind list, pattern cycled over num_layers."""
        p = self.layer_pattern
        return tuple(p[i % len(p)] for i in range(self.num_layers))

    def param_count(self) -> int:
        """Analytic parameter count (used for roofline MODEL_FLOPS)."""
        n = 0
        n += self.vocab_size * self.d_model          # embed
        if not self.tie_embeddings:
            n += self.vocab_size * self.d_model
        for kind in self.layer_kinds():
            n += self._layer_params(kind)
        if self.encoder_layers:
            for _ in range(self.encoder_layers):
                n += self._layer_params("attn")      # encoder full attn
                n += 2 * self.d_model                # extra norm
            # cross-attention per decoder layer
            n += self.num_layers * (
                self.d_model * self.q_dim + 2 * self.d_model * self.kv_dim
                + self.q_dim * self.d_model + self.d_model)
        n += self.d_model                            # final norm
        return n

    def _layer_params(self, kind: str) -> int:
        d, f = self.d_model, self.d_ff
        n = 2 * d                                     # norms (pre attn/mlp)
        if self.post_norm:
            n += 2 * d
        if kind in ATTN_KINDS:
            n += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            if self.qkv_bias:
                n += self.q_dim + 2 * self.kv_dim
        elif kind == "rglru":
            w = self.lru_width or d
            # linear in x2 (gated), conv, lru params, linear out
            n += 2 * d * w + 4 * w + 3 * w + w * d
        elif kind == "ssd":
            di, ns, nh = self.d_inner, self.ssm_state, self.ssm_heads
            n += d * (2 * di + 2 * ns + nh)           # in_proj (z,x,B,C,dt)
            n += self.ssm_conv * (di + 2 * ns)        # conv
            n += 3 * nh + di                          # A,D,dt_bias,norm
            n += di * d                               # out_proj
        # MLP / MoE (ssd blocks in mamba2 have no separate MLP)
        if kind == "ssd":
            return n
        if self.num_experts > 0:
            n += d * self.num_experts                 # router
            n += self.num_experts * 3 * d * f         # gated mlp per expert
        else:
            n += 3 * d * f                            # gated mlp
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE counts only routed experts)."""
        if self.num_experts == 0:
            return self.param_count()
        total = self.param_count()
        d, f = self.d_model, self.d_ff
        dead = (self.num_experts - self.experts_per_token) * 3 * d * f
        return total - self.num_layers * dead


@dataclass(frozen=True)
class FLConfig:
    """FedHC topology + schedule (paper §III, Algorithm 1)."""

    num_clients: int = 16             # satellites participating
    num_clusters: int = 4             # K
    client_axis: str = "data"         # "data" | "pod": mesh placement of clients
    local_epochs: int = 1             # lambda: local SGD epochs per round
    rounds_per_global: int = 5        # m: cluster rounds per ground-station agg
    dropout_threshold: float = 0.3    # Z: re-cluster trigger (Alg.1 line 16)
    loss_weighted: bool = True        # Eq. 12 weights vs plain FedAvg Eq. 5
    # MAML re-clustering (Eq. 16-17)
    maml_inner_lr: float = 1e-3       # alpha
    maml_outer_lr: float = 1e-3       # beta
    maml_inner_steps: int = 1
    # k-means PS selection (Eq. 13-15)
    kmeans_iters: int = 32
    kmeans_tol: float = 1e-4


@dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "sgd"            # paper uses small-batch SGD
    learning_rate: float = 0.01
    momentum: float = 0.0
    weight_decay: float = 0.0
    grad_accum: int = 1               # microbatch accumulation steps
    remat: bool = True                # activation checkpoint each layer
    seed: int = 0
    param_dtype: str = "float32"      # FL-sim default; large archs use bf16
    logical_rules: Tuple[Tuple[str, Optional[str]], ...] = ()


def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)


def depth_cut(cfg, layers: int):
    """``cfg`` at full width with ``layers`` layers: the stack's and, for
    an encoder-decoder, the encoder's (at most its own)."""
    kw = dict(num_layers=layers)
    if cfg.encoder_layers:
        kw["encoder_layers"] = min(layers, cfg.encoder_layers)
    return replace(cfg, **kw)


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family variant: <=2 layers (rounded up to one full
    pattern cycle), d_model<=512, <=4 experts.  Used by CPU smoke tests."""
    pat = cfg.layer_pattern
    layers = max(2, len(pat))
    # keep GQA ratio
    heads = max(2, min(4, cfg.num_heads))
    kv = max(1, min(heads, cfg.num_kv_heads))
    while heads % kv:
        kv -= 1
    head_dim = 32
    d_model = min(256, cfg.d_model)
    kw = dict(
        num_layers=layers,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=head_dim,
        d_ff=min(512, cfg.d_ff) if cfg.d_ff else 0,
        vocab_size=min(512, cfg.vocab_size),
        window_size=min(64, cfg.window_size),
        dtype="float32",
    )
    if cfg.num_experts:
        kw["num_experts"] = min(4, cfg.num_experts)
        kw["experts_per_token"] = min(2, cfg.experts_per_token)
    if cfg.ssm_state:
        kw["ssm_state"] = min(32, cfg.ssm_state)
        kw["ssm_head_dim"] = 32
        kw["ssm_chunk"] = 32
    if cfg.lru_width:
        kw["lru_width"] = d_model
    if cfg.encoder_layers:
        kw["encoder_layers"] = 2
    if cfg.frontend_len:
        kw["frontend_len"] = min(32, cfg.frontend_len)
    return replace(cfg, name=cfg.name + "-smoke", **kw)
