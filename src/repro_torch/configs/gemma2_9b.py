"""gemma2-9b — dense GQA with alternating local/global attention + softcaps.

[arXiv:2408.00118; hf]  42L d_model=3584 16H (kv=8) d_ff=14336 vocab=256000,
head_dim=256, local window 4096 on alternating layers, attn logit softcap 50,
final logit softcap 30, GeGLU, pre+post block norms, scaled embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=256_000,
    head_dim=256,
    rope_theta=10_000.0,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    local_window=4096,
    layer_pattern="local_global",
    act="geglu",
    post_block_norm=True,
    emb_scale=True,
    tie_embeddings=True,
)
