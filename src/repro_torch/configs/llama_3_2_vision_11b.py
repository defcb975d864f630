"""llama-3.2-vision-11b — VLM backbone with interleaved cross-attention layers.

[hf:meta-llama/Llama-3.2-11B-Vision; unverified]  40L d_model=4096 32H (kv=8)
d_ff=14336 vocab=128256; a cross-attention block every 5th layer attends to
image patch embeddings.  The vision encoder is a STUB: ``input_specs`` provides
precomputed patch embeddings (batch, n_image_tokens, d_model).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128_256,
    head_dim=128,
    rope_theta=500_000.0,
    cross_attn_every=5,
    n_image_tokens=1024,
)
