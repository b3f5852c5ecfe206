"""llava1.5-13b — the paper's LARGE-model test case (HBS experiments).

Llama-13B backbone as the paper models it: 40L d_model=5120 40H (MHA)
MLP = 2 matrices d -> 4d -> d (the paper's kernel list has W_MLP1/W_MLP2 only,
which also reproduces its ~13B parameter count and ~27 GB KV @ 33k ctx).
Vision tower is a stub (image tokens arrive as part of the prefill).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava15-13b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,          # paper models full MHA KV (27 GB @ 33k ctx)
    head_dim=128,
    d_ff=20480,             # 4*d, two-matrix MLP per the paper's Sec. II
    vocab=32000,
    prefix_len=576,         # CLIP ViT-L/14-336px patch tokens (stub)
    source_len=576,
    gated_mlp=False,
    max_context=32768 + 512,
    dtype="float16",        # paper runs single-precision FP16
    notes="Paper Fig.1-3 + Table I subject.",
)
