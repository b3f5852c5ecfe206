"""paligemma-3b [vlm] — arXiv:2407.07726 (hf-verified).

Gemma-2B backbone: 18L d_model=2048 8H (GQA kv=1) d_ff=16384 vocab=257216.
SigLIP frontend is a STUB: input_specs() provides 256 patch embeddings that
form a bidirectional prefix in the LM stream (prefix-LM masking).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab=257216,
    prefix_len=256,
    source_len=256,
    prefix_bidirectional=True,
    tie_embeddings=True,
    gated_mlp=True,
    max_context=8192,
)
