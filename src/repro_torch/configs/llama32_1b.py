"""llama3.2-1b — the paper's SMALL-model test case (chiplet study).

16L d_model=2048 d_ff=8192 vocab=128256. The paper's workload model uses
full-width (MHA) KV: its quoted ~68 MB KV cache @ 512 ctx equals
2*512*2048*2B*16L; real Llama-3.2-1B uses GQA kv=8, which we also provide
via ``CONFIG_GQA`` for the beyond-paper comparison.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,          # paper's MHA-width KV (matches its 68 MB claim)
    head_dim=64,
    d_ff=8192,
    vocab=128256,
    gated_mlp=True,
    tie_embeddings=True,
    max_context=131072,
    dtype="float16",
    notes="Paper Fig.4 subject (chiplet study).",
)

CONFIG_GQA = CONFIG.replace(name="llama3.2-1b-gqa", n_kv_heads=8,
                            notes="Real HF config (GQA kv=8) for comparison.")
