"""whisper-medium [audio] — arXiv:2212.04356 (unverified tier).

Enc-dec: 24+24L d_model=1024 16H d_ff=4096 vocab=51865. Conv frontend is a
STUB: input_specs() provides 1500 precomputed frame embeddings.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium",
    family="encdec",
    n_layers=24,            # decoder layers
    enc_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab=51865,
    source_len=1500,        # 30 s audio -> 1500 frames after conv stub
    qkv_bias=True,
    gated_mlp=False,        # GELU MLP (2 matrices)
    tie_embeddings=True,    # whisper ties proj_out to the token embedding
    # real whisper caps targets at 448; the 32k decode CELLS are lowered
    # structurally (pos table extended) per the assignment's shape grid
    max_context=32776,
    notes="Cross-KV computed once per request; self-KV grows per token. "
          "Real max target len is 448; 32k cells are structural.",
)
