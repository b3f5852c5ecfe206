"""Feed-forward blocks. Only the dense FFN of the paged path is ported;
the mixture-of-experts FFN is ROADMAP item A7."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import common as cm


def init_dense_ffn(generator: torch.Generator, cfg: ArchConfig, d_ff: int,
                   dtype, device):
    n_up = 2 * d_ff if cfg.gated_mlp else d_ff
    return {"up": cm.dense_init(generator, cfg.d_model, n_up, dtype, device),
            "down": cm.dense_init(generator, d_ff, cfg.d_model, dtype,
                                  device)}


def dense_ffn(p, x, gated: bool):
    h = cm.dense(p["up"], x)
    if gated:
        gate, up = h.chunk(2, dim=-1)
        h = cm.swiglu(gate, up)
    else:
        h = F.gelu(h, approximate="tanh")   # jax.nn.gelu's default
    return cm.dense(p["down"], h)
