"""Shared PyTorch building blocks of the paged serving path: dense layers,
RMSNorm, rotary embeddings and the SwiGLU activation.

Parameters are plain dicts of tensors in the reference package's layout
(``dense`` weights are ``(d_in, d_out)`` and apply as ``x @ w``), so weights
move between the two packages unchanged (``models.convert``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def dense_init(generator: torch.Generator, d_in: int, d_out: int, dtype,
               device, *, bias: bool = False, scale: float = None):
    """Normal(0, 1/sqrt(d_in)) weights drawn in f32, then cast."""
    scale = scale if scale is not None else d_in ** -0.5
    w = torch.randn((d_in, d_out), generator=generator, dtype=torch.float32,
                    device=generator.device) * scale
    p = {"w": w.to(device=device, dtype=dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def dense(p, x):
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def rms_norm(x, w, eps: float = 1e-6):
    """RMSNorm in f32 with the ``(1 + w)`` gain; returns x's dtype."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)


def rope_freqs(head_dim: int, theta: float = 10000.0, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_cos_sin(positions, head_dim: int, theta: float = 10000.0):
    """cos/sin of the split-half rotary angles, (..., seq, 1, head_dim/2)
    in f32: computed once per forward and shared by every layer."""
    freqs = rope_freqs(head_dim, theta, positions.device)       # (hd/2,)
    ang = positions[..., :, None].float() * freqs               # (..., S, hd/2)
    return torch.cos(ang)[..., :, None, :], torch.sin(ang)[..., :, None, :]


def rotate(x, cos, sin):
    """Apply rotary angles from ``rope_cos_sin`` to x: (..., seq, heads,
    head_dim), in f32; returns x's dtype."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta: float = 10000.0):
    """Split-half rotary embedding in f32. x: (..., seq, heads, head_dim);
    positions: (..., seq)."""
    return rotate(x, *rope_cos_sin(positions, x.shape[-1], theta))


def swiglu(gate, up):
    return F.silu(gate) * up
