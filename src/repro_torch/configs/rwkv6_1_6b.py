"""rwkv6-1.6b ("Finch") — attention-free, data-dependent-decay linear attention.

[arXiv:2404.05892; unverified]  24L d_model=2048 d_ff=7168 vocab=65536,
head_size=64 (32 heads).  No experts: the channel-mix is its feed-forward.
"""
from repro_torch.configs.base import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,              # d_model / head_size
    n_kv_heads=32,
    d_ff=7168,
    vocab_size=65_536,
    head_dim=64,
    use_rope=False,
    norm="layernorm",
    act="gelu_mlp",          # channel-mix uses its own relu^2 path internally
    rwkv=RWKVConfig(head_size=64, decay_lora=64, chunk=128),
)
