"""smollm-360m — llama-architecture small dense model.

[hf:HuggingFaceTB/SmolLM-360M; hf]  32L d_model=960 15H (kv=5) d_ff=2560
vocab=49152, tied embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    d_ff=2560,
    vocab_size=49_152,
    head_dim=64,
    rope_theta=10_000.0,
    tie_embeddings=True,
)
