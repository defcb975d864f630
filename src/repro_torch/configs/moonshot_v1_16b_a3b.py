"""moonshot-v1-16b-a3b (Moonlight-16B-A3B) — 64-expert top-6 MoE.

[hf:moonshotai/Moonlight-16B-A3B; hf]  48L d_model=2048 16H (kv=16)
d_ff(expert)=1408 vocab=163840, 64 routed experts top-6 + 2 shared,
sigmoid gating with top-k renormalization (DeepSeek-V3 style), first layer dense.
64 experts is exactly the paper's Qwen2-MoE skew-sensitivity regime (§4.7).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=11264,              # dense (first-layer) FFN width
    vocab_size=163_840,
    head_dim=128,
    rope_theta=50_000.0,
    moe=MoEConfig(
        n_experts=64,
        top_k=6,
        d_ff_expert=1408,
        n_shared_experts=2,
        gating="sigmoid",
        norm_topk=True,
        routed_scale=2.446,
        first_dense_layers=1,
        d_ff_dense=11264,
        block_m=128,
    ),
)
