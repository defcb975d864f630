"""Model configuration dataclasses (copy of ``repro.configs.base``, cut to
the fields and helpers the port uses).

All configs are frozen dataclasses, field for field the reference's, so a
config built here and one built there describe the same model."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-Experts block config (the paper's subject)."""

    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    gating: str = "softmax"          # "softmax" (Mixtral/DSv2) | "sigmoid" (DSv3)
    norm_topk: bool = False          # renormalize selected weights to sum to 1
    routed_scale: float = 1.0        # DeepSeek routed_scaling_factor
    first_dense_layers: int = 0      # leading layers use a dense FFN instead
    d_ff_dense: int = 0              # d_ff of those dense layers (0 -> 4*d_model)
    capacity_factor: float = 1.25    # EP dispatch buffer headroom
    block_m: int = 128               # grouped-GEMM fixed BLOCK_M (paper §3.2)


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 multi-head latent attention."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD mixer."""

    d_state: int = 64
    head_dim: int = 64
    expand: int = 2
    conv_kernel: int = 4
    n_groups: int = 1
    chunk: int = 128


@dataclass(frozen=True)
class RWKVConfig:
    """RWKV6 "Finch" time-mix."""

    head_size: int = 64
    decay_lora: int = 64
    chunk: int = 128


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense|moe|ssm|hybrid|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads

    # --- attention ---
    causal: bool = True
    rope_theta: float = 10_000.0
    use_rope: bool = True
    qkv_bias: bool = False
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    local_window: Optional[int] = None
    layer_pattern: str = "global"    # "global" | "local_global" (alternating)

    # --- block structure ---
    norm: str = "rmsnorm"            # rmsnorm|layernorm
    act: str = "swiglu"              # swiglu|geglu|gelu_mlp
    mlp_bias: bool = False
    post_block_norm: bool = False
    tie_embeddings: bool = False
    emb_scale: bool = False

    # --- family sub-configs ---
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None

    # --- vlm ---
    cross_attn_every: int = 0
    n_image_tokens: int = 1024

    # --- encoder-only (audio) ---
    encoder_only: bool = False

    # --- hybrid (zamba2) ---
    attn_every: int = 0
    n_shared_attn_blocks: int = 2

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def is_moe(self) -> bool:
        return self.moe is not None

    @property
    def has_decode(self) -> bool:
        """Encoder-only architectures have no autoregressive decode step."""
        return not self.encoder_only

    @property
    def supports_500k(self) -> bool:
        """Sub-quadratic archs only (SSM / hybrid / linear attention)."""
        return self.family in ("ssm", "hybrid")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ----------------------------------------------------------------------
# The input shapes of the architecture x shape grid (seq_len,
# global_batch, kind): the reference's, cell for cell
# ----------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # "train" | "prefill" | "decode"


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)

SHAPE_BY_NAME = {s.name: s for s in SHAPES}


def cell_is_runnable(cfg: ModelConfig,
                     shape: ShapeConfig) -> Tuple[bool, str]:
    """(runnable, reason-if-not) for an (arch x shape) cell."""
    if shape.kind == "decode" and not cfg.has_decode:
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k" and not cfg.supports_500k:
        return False, ("524k decode needs sub-quadratic attention "
                       "(full-attn arch)")
    return True, ""


def reduced(cfg: ModelConfig, *, layers: int = 2, d_model: int = 128,
            n_heads: int = 4, vocab: int = 512) -> ModelConfig:
    """Shrink a config for CPU smoke tests, preserving its structural family
    (the reference's ``reduced``, line for line)."""
    kv = max(1, min(cfg.n_kv_heads, n_heads) * n_heads // max(cfg.n_heads, 1)) \
        if cfg.n_kv_heads < cfg.n_heads else n_heads
    kw = dict(
        n_layers=layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=kv,
        head_dim=d_model // n_heads,
        d_ff=d_model * 3,
        vocab_size=min(cfg.vocab_size, vocab),
        local_window=(64 if cfg.local_window else None),
    )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, n_experts=min(cfg.moe.n_experts, 8), top_k=min(cfg.moe.top_k, 2),
            d_ff_expert=d_model * 2, d_ff_dense=d_model * 3,
            first_dense_layers=min(cfg.moe.first_dense_layers, 1), block_m=8)
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(q_lora_rank=48, kv_lora_rank=32,
                              qk_nope_head_dim=16, qk_rope_head_dim=8,
                              v_head_dim=16)
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, d_state=16, head_dim=16, chunk=16)
    if cfg.rwkv is not None:
        kw["rwkv"] = dataclasses.replace(cfg.rwkv, head_size=16, decay_lora=8, chunk=16)
    if cfg.cross_attn_every:
        kw["cross_attn_every"] = 2
        kw["n_image_tokens"] = 16
    if cfg.attn_every:
        kw["attn_every"] = 2
        kw["n_layers"] = max(layers, 4)
    return cfg.replace(**kw)
