"""The paper's four benchmark MoE configurations (Table 1): a single MoE
layer each, not a full model."""
from dataclasses import dataclass
from typing import Dict, Tuple


@dataclass(frozen=True)
class PaperMoE:
    name: str
    n_experts: int      # E
    top_k: int          # k
    d_model: int        # d
    d_ffn: int          # d_ffn
    gating: str = "softmax"


PAPER_CONFIGS: Dict[str, PaperMoE] = {
    "mixtral-8x7b": PaperMoE("mixtral-8x7b", 8, 2, 4096, 14336),
    "mixtral-8x22b": PaperMoE("mixtral-8x22b", 8, 2, 6144, 16384),
    "deepseek-v3": PaperMoE("deepseek-v3", 256, 8, 7168, 2048, gating="sigmoid"),
    "qwen2-moe-57b": PaperMoE("qwen2-moe-57b", 64, 4, 3584, 2560),
}

# Token-count sweep used by paper Tables 2-3.
TOKEN_SWEEP: Tuple[int, ...] = (32, 128, 512, 2048)
