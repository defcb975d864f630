"""starcoder2-3b — dense code model, GQA kv=2, RoPE, ungated MLP, layernorm.

[arXiv:2402.19173; hf]  30L d_model=3072 24H (kv=2) d_ff=12288 vocab=49152.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12288,
    vocab_size=49_152,
    head_dim=128,
    rope_theta=999_999.4,
    norm="layernorm",
    act="gelu_mlp",
    mlp_bias=True,
    qkv_bias=True,
    tie_embeddings=True,
)
