"""deepseek-v2-236b — MoE with multi-head latent attention (MLA).

[arXiv:2405.04434; hf]  60L d_model=5120 128H d_ff(expert)=1536 vocab=102400,
MLA kv_lora=512, 2 shared + 160 routed experts top-6, first layer dense.
This is the PRIMARY target for the paper's grouped-GEMM dispatch technique.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,          # MLA: heads share one compressed latent cache
    d_ff=12288,              # dense (first-layer) FFN width
    vocab_size=102_400,
    head_dim=192,            # qk_nope (128) + qk_rope (64)
    rope_theta=10_000.0,
    moe=MoEConfig(
        n_experts=160,
        top_k=6,
        d_ff_expert=1536,
        n_shared_experts=2,
        gating="softmax",
        norm_topk=False,
        routed_scale=16.0,
        first_dense_layers=1,
        d_ff_dense=12288,
        block_m=128,
    ),
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
)
