"""deepseek-v2-236b [moe] — arXiv:2405.04434 (hf-verified).

60L d_model=5120 128H (MLA kv_lora=512) d_ff_expert=1536 vocab=102400,
MoE: 2 shared + 160 routed top-6, first layer dense (d_ff=12288).
"""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,          # MLA: all heads share one latent cache
    head_dim=128,            # qk_nope head dim
    d_ff=12288,              # dense (first-layer) FFN hidden
    vocab=102400,
    moe=MoEConfig(n_experts=160, top_k=6, n_shared=2, d_ff_expert=1536,
                  first_dense=1, d_ff_dense=12288),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536, rope_head_dim=64,
                  qk_nope_head_dim=128, v_head_dim=128),
    gated_mlp=True,
    max_context=131072,
    notes="MLA compressed KV (512+64 per token per layer); 236B total params.",
)
