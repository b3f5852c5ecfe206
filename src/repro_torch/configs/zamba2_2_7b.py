"""zamba2-2.7b [hybrid] — arXiv:2411.15242 (hf-verified).

54 Mamba2 blocks d_model=2560 ssm_state=64 + one SHARED attention block
(32H kv=32, d_ff=10240 MLP) applied every 6 backbone blocks. vocab=32000.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,            # shared attn block over concat width 2*d/ projected
    d_ff=10240,
    vocab=32000,
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, n_groups=1,
                  conv_width=4, chunk=128),
    attn_every=6,
    gated_mlp=False,
    tie_embeddings=True,
    max_context=1 << 20,
    notes="Hybrid: O(1) SSM state + 9 shared-attn KV sites; sub-quadratic "
          "context => long_500k runs.",
)
