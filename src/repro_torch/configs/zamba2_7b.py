"""zamba2-7b — hybrid Mamba2 backbone + shared attention blocks.

[arXiv:2411.15242; unverified]  81L d_model=3584 32H (kv=32) d_ff=14336
ssm_state=64 vocab=32000.  ``n_layers`` counts the Mamba2 mixer layers; an
attention+MLP block runs before every ``attn_every`` of them: 13 groups of
[shared_attn, mamba x 6], then [shared_attn, mamba x 3].  The groups'
attention blocks are 2 unique blocks used round-robin; the last one is a
block of its own (``models/lm.py``).  The concat-embedding input projection
of the original is simplified to a residual application.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32_000,
    head_dim=112,
    rope_theta=10_000.0,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, conv_kernel=4, chunk=128),
    attn_every=6,
    n_shared_attn_blocks=2,
)
