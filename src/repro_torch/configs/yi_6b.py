"""yi-6b [dense] — arXiv:2403.04652 (hf-verified). Llama-arch GQA.

32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="yi-6b",
    family="dense",
    n_layers=32,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_model=4096,
    d_ff=11008,
    vocab=64000,
    gated_mlp=True,
    max_context=32768,
)
