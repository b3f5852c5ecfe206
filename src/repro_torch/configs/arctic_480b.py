"""arctic-480b [moe] — hf:Snowflake/snowflake-arctic-base (hf-verified).

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128 experts top-2 with a parallel dense residual FFN per layer.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab=32000,
    moe=MoEConfig(n_experts=128, top_k=2, d_ff_expert=4864,
                  dense_residual=True, d_ff_dense=4864),
    gated_mlp=True,
    max_context=4096,
    notes="Dense-MoE hybrid residual: every layer = attn + dense FFN + MoE.",
)
