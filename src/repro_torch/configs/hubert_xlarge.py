"""hubert-xlarge — encoder-only audio transformer backbone.

[arXiv:2106.07447; unverified]  48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504.
The conv feature extractor / positional-conv frontend is a STUB: ``input_specs``
provides precomputed frame embeddings of shape (batch, frames, d_model); the
model consumes them directly and trains with masked-prediction over the 504-way
codebook vocabulary.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    head_dim=80,
    causal=False,
    encoder_only=True,
    use_rope=False,          # HuBERT uses conv positional encoding (stubbed)
    norm="layernorm",
    act="gelu_mlp",
    mlp_bias=True,
    qkv_bias=True,
)
