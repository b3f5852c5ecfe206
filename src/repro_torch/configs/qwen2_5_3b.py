"""qwen2.5-3b [dense] — hf:Qwen/Qwen2.5-3B family (hf-verified).

36L d_model=2048 16H (GQA kv=2) d_ff=11008 vocab=151936, QKV bias.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-3b",
    family="dense",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    head_dim=128,
    d_ff=11008,
    vocab=151936,
    qkv_bias=True,
    gated_mlp=True,
    tie_embeddings=True,
    max_context=32768,
)
