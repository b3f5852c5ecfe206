"""mamba2-130m [ssm] — arXiv:2405.21060 (unverified tier). SSD, attention-free.

24L d_model=768 ssm_state=128 vocab=50280. d_inner=1536, 24 heads x 64.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    head_dim=1,  # unused (attention-free)
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, n_groups=1,
                  conv_width=4, chunk=128),
    gated_mlp=False,
    tie_embeddings=True,
    max_context=1 << 20,
    notes="Attention-free: no KV cache; paper's QKV-tier placement class "
          "is inapplicable (see DESIGN.md SSArch-applicability).",
)
