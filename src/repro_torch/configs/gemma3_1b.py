"""gemma3-1b [dense] — hf:google/gemma-3-1b-pt (unverified tier).

26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144,
5 local(sliding-512):1 global attention pattern, head_dim=256.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab=262144,
    sliding_window=512,
    local_global_ratio=5,
    logit_softcap=30.0,
    tie_embeddings=True,
    gated_mlp=True,
    max_context=32768,
    notes="5:1 local:global; local layers cap KV at the 512 window.",
)
