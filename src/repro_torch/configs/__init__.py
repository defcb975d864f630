"""Config registry: ``get_config("<arch-id>")`` for every architecture of
the reference: moonshot-v1-16b-a3b and deepseek-v2-236b (MLA), the dense
family: qwen2-7b, smollm-360m, starcoder2-3b and gemma2-9b, the recurrent
ones: rwkv6-1.6b (``ssm``) and zamba2-7b (``hybrid``), llama-3.2-vision-11b
(``vlm``: cross-attention to image embeddings) and hubert-xlarge
(``audio``: an encoder trained by masked prediction)."""
from repro_torch.configs.base import (SHAPE_BY_NAME, SHAPES, MLAConfig,
                                      ModelConfig, MoEConfig, RWKVConfig,
                                      ShapeConfig, SSMConfig,
                                      cell_is_runnable, reduced)
from repro_torch.configs import (deepseek_v2_236b, gemma2_9b, hubert_xlarge,
                                 llama_3_2_vision_11b, moonshot_v1_16b_a3b,
                                 qwen2_7b, rwkv6_1_6b, smollm_360m,
                                 starcoder2_3b, zamba2_7b)
from repro_torch.configs.paper import PAPER_CONFIGS, TOKEN_SWEEP, PaperMoE

REGISTRY = {m.CONFIG.name: m.CONFIG
            for m in (moonshot_v1_16b_a3b, deepseek_v2_236b, qwen2_7b,
                      smollm_360m, starcoder2_3b, gemma2_9b, rwkv6_1_6b,
                      zamba2_7b, llama_3_2_vision_11b, hubert_xlarge)}
ARCH_NAMES = tuple(REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[name]


__all__ = [
    "ModelConfig", "MoEConfig", "MLAConfig", "SSMConfig", "RWKVConfig",
    "ShapeConfig", "SHAPES", "SHAPE_BY_NAME", "cell_is_runnable",
    "reduced", "REGISTRY", "ARCH_NAMES", "get_config",
    "PAPER_CONFIGS", "TOKEN_SWEEP", "PaperMoE",
]
