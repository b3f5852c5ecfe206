"""Multi-head latent attention (DeepSeek-V2) in PyTorch (the reference is
``repro/models/mla.py``).

The prompt takes the decompressed path: the latent ``c`` is expanded to
per-head keys and values and attended causally at head width
``qk_nope_head_dim + rope_head_dim`` through the masked attention (the
reference's XLA path: its flash route needs a head width that is a
multiple of 128, and MLA's is 192). Decode takes the absorbed path: the
query is folded through ``k_up`` into the latent space, so a step reads
only the ``(B, Lmax, kv_lora_rank)`` latent and the ``(B, Lmax,
rope_head_dim)`` rope key of each layer, whatever the head count.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import common as cm


def init_mla(generator: torch.Generator, cfg: ArchConfig, dtype, device):
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads

    def lin(d_in, d_out):
        return cm.dense_init(generator, d_in, d_out, dtype, device)

    def up(dv):
        w = torch.randn((H, m.kv_lora_rank, dv), generator=generator,
                        dtype=torch.float32, device=generator.device)
        return (w * m.kv_lora_rank ** -0.5).to(device=device, dtype=dtype)
    return {
        "q_down": lin(d, m.q_lora_rank),
        "q_norm": torch.zeros((m.q_lora_rank,), dtype=dtype, device=device),
        "q_up": lin(m.q_lora_rank,
                    H * (m.qk_nope_head_dim + m.rope_head_dim)),
        "kv_down": lin(d, m.kv_lora_rank + m.rope_head_dim),
        "kv_norm": torch.zeros((m.kv_lora_rank,), dtype=dtype, device=device),
        "k_up": up(m.qk_nope_head_dim),
        "v_up": up(m.v_head_dim),
        "o_proj": lin(H * m.v_head_dim, d),
    }


def _q_proj(p, x, cfg: ArchConfig, positions):
    """(q_nope, q_rope) (B, S, H, dn), (B, S, H, dr): the q-LoRA with its
    rms-norm, the rope half rotated at ``positions`` (B, S)."""
    m = cfg.mla
    B, S, _ = x.shape
    q = cm.dense(p["q_up"], cm.rms_norm(cm.dense(p["q_down"], x),
                                        p["q_norm"]))
    q = q.reshape(B, S, cfg.n_heads, m.qk_nope_head_dim + m.rope_head_dim)
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.rope_head_dim], dim=-1)
    return q_nope, cm.apply_rope(q_rope, positions)


def _kv_latent(p, x, cfg: ArchConfig, positions):
    """The cache entry: the normed latent c (B, S, r) and the rope key
    (B, S, dr) that every head shares."""
    m = cfg.mla
    c, k_rope = cm.dense(p["kv_down"], x).split(
        [m.kv_lora_rank, m.rope_head_dim], dim=-1)
    c = cm.rms_norm(c, p["kv_norm"])
    k_rope = cm.apply_rope(k_rope[:, :, None, :], positions)[:, :, 0, :]
    return c, k_rope


def _scale(cfg: ArchConfig) -> float:
    m = cfg.mla
    return (m.qk_nope_head_dim + m.rope_head_dim) ** -0.5


def mla_prefill_attn(p, x, cfg: ArchConfig, positions):
    """Decompressed causal attention over the whole prompt x (B, S, d).
    Returns the block output and the cache entry (c, k_rope)."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    q_nope, q_rope = _q_proj(p, x, cfg, positions)
    c, k_rope = _kv_latent(p, x, cfg, positions)
    k_nope = torch.einsum("bsr,hrd->bshd", c, p["k_up"].to(c.dtype))
    v = torch.einsum("bsr,hrd->bshd", c, p["v_up"].to(c.dtype))
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, H, m.rope_head_dim)], dim=-1)
    out = cm.attention(q_full, k_full, v, mask_kind="causal",
                       scale=_scale(cfg))
    out = out.reshape(B, S, H * m.v_head_dim)
    return cm.dense(p["o_proj"], out), (c, k_rope)


def mla_decode_attn(p, x, cfg: ArchConfig, cache, pos):
    """Absorbed decode of x (B, 1, d) at ``pos`` (a host int or a 0-d or
    (1,) int32 device tensor, as ``common.write_rows`` takes it): the new
    latent and rope key land in ``cache`` ({"c": (B, Lmax, r), "k_rope":
    (B, Lmax, dr)}) in place, then f32 scores over the latent and the rope
    cache, masked past ``pos``, and the context mapped out through
    ``v_up``. A step reads Lmax * (r + dr) cache entries a sequence,
    independent of the head count."""
    m = cfg.mla
    B, S, _ = x.shape                                      # S == 1
    H = cfg.n_heads
    positions = cm.decode_positions(pos, B, x.device)
    q_nope, q_rope = _q_proj(p, x, cfg, positions)
    c_new, k_rope_new = _kv_latent(p, x, cfg, positions)
    cache_c, cache_kr = cache["c"], cache["k_rope"]
    L = cache_c.shape[1]
    cm.write_rows(cache_c, c_new, pos)
    cm.write_rows(cache_kr, k_rope_new, pos)
    # absorb q through W_uk: (B,1,H,dn) x (H,r,dn) -> (B,1,H,r)
    q_lat = torch.einsum("bshd,hrd->bshr", q_nope, p["k_up"].to(q_nope.dtype))
    c32 = cache_c.float()
    s_lat = torch.einsum("bshr,blr->bhsl", q_lat.float(), c32)
    s_rope = torch.einsum("bshd,bld->bhsl", q_rope.float(), cache_kr.float())
    scores = (s_lat + s_rope) * _scale(cfg)                # (B,H,1,L)
    valid = torch.arange(L, device=x.device) <= pos
    scores = torch.where(valid, scores, torch.full_like(scores, cm.NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhsl,blr->bshr", probs, c32)       # (B,1,H,r)
    out = torch.einsum("bshr,hrd->bshd", ctx, p["v_up"].float())
    out = out.reshape(B, S, H * m.v_head_dim).to(x.dtype)
    return cm.dense(p["o_proj"], out)


def init_mla_cache(cfg: ArchConfig, batch: int, max_len: int, dtype, device,
                   n_layers: int = None):
    """The latent cache: {"c": (B, Lmax, r), "k_rope": (B, Lmax, dr)}, or
    with ``n_layers`` the same on a leading layer axis."""
    m = cfg.mla
    lead = () if n_layers is None else (n_layers,)
    return {"c": torch.zeros((*lead, batch, max_len, m.kv_lora_rank),
                             dtype=dtype, device=device),
            "k_rope": torch.zeros((*lead, batch, max_len, m.rope_head_dim),
                                  dtype=dtype, device=device)}
