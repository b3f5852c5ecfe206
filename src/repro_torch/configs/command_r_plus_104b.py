"""command-r-plus-104b [dense] — hf:CohereForAI/c4ai-command-r-plus (unverified).

64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000, no biases.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    head_dim=128,
    d_ff=33792,
    vocab=256000,
    qkv_bias=False,
    gated_mlp=True,
    tie_embeddings=True,
    max_context=131072,
    notes="Largest dense weight class in the pool; GQA 96:8.",
)
