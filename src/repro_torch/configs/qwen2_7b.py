"""qwen2-7b — dense GQA transformer with QKV bias.

[arXiv:2407.10671; hf]  28L d_model=3584 28H (kv=4) d_ff=18944 vocab=152064.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b",
    family="dense",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab_size=152_064,
    head_dim=128,
    rope_theta=1_000_000.0,
    qkv_bias=True,
)
