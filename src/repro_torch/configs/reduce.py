"""Reduced same-family configs for CPU smoke tests and examples."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig, SSMConfig


def reduced(cfg: ArchConfig, *, d_model: int = 64, n_layers: int = 0,
            vocab: int = 256) -> ArchConfig:
    """Shrink width/depth/experts/tables while keeping the family structure
    (MoE stays MoE, MLA stays MLA, local:global pattern survives, ...)."""
    kw = dict(
        d_model=d_model,
        n_layers=n_layers or min(cfg.n_layers, 4),
        vocab=vocab,
        d_ff=d_model * 2,
        max_context=512,
    )
    if cfg.n_heads:
        kw["n_heads"] = 4
        kw["n_kv_heads"] = min(max(cfg.n_kv_heads * 4 // max(cfg.n_heads, 1), 1), 4)
        kw["head_dim"] = 16
    if cfg.moe is not None:
        kw["n_layers"] = n_layers or 3
        kw["moe"] = MoEConfig(
            n_experts=8, top_k=min(cfg.moe.top_k, 2),
            d_ff_expert=d_model // 2,
            n_shared=1 if cfg.moe.n_shared else 0,
            dense_residual=cfg.moe.dense_residual,
            first_dense=min(cfg.moe.first_dense, 1),
            d_ff_dense=d_model * 2 if cfg.moe.d_ff_dense else 0)
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(kv_lora_rank=32, q_lora_rank=48,
                              rope_head_dim=8, qk_nope_head_dim=16,
                              v_head_dim=16)
    if cfg.ssm is not None:
        kw["ssm"] = SSMConfig(state_dim=16, head_dim=16,
                              expand=cfg.ssm.expand, n_groups=1,
                              conv_width=cfg.ssm.conv_width, chunk=16)
    if cfg.sliding_window:
        kw["sliding_window"] = 8
    if cfg.attn_every:
        kw["n_layers"] = n_layers or 4
        kw["attn_every"] = 2
    if cfg.enc_layers:
        kw["enc_layers"] = 2
        kw["source_len"] = 12
    if cfg.prefix_len:
        kw["prefix_len"] = 8
        kw["source_len"] = 8
    return dataclasses.replace(cfg, **kw)
