"""Mamba-2 block through the SSD (state-space duality) algorithm, in
PyTorch (the reference is ``repro/models/ssd.py``).

The prompt takes the chunked SSD decomposition (arXiv:2405.21060): a
quadratic term inside each chunk and a recurrence over the chunk states
(the reference's ``lax.scan``, here a loop over chunks of tensor ops), in
f32. Decode keeps an O(1) state a layer: the conv tail and the SSM state,
updated in place. Nothing here reads a device value back to the host.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import common as cm


def _dims(cfg: ArchConfig):
    s = cfg.ssm
    d = cfg.d_model
    return s, d, s.d_inner(d), s.n_heads(d), s.n_groups, s.state_dim


def init_mamba(generator: torch.Generator, cfg: ArchConfig, dtype, device):
    """One block's weights; ``A_log``, ``D`` and ``dt_bias`` stay f32 as in
    the reference."""
    s, d, di, nh, ng, N = _dims(cfg)
    conv_dim = di + 2 * ng * N
    gdev = generator.device
    conv_w = torch.randn((s.conv_width, conv_dim), generator=generator,
                         dtype=torch.float32, device=gdev) * 0.1
    u = torch.rand((nh,), generator=generator, dtype=torch.float32,
                   device=gdev)
    dt_init = torch.exp(u * (math.log(0.1) - math.log(0.001))
                        + math.log(0.001))
    dt_bias = dt_init + torch.log(-torch.expm1(-dt_init))
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": cm.dense_init(generator, d, 2 * di + 2 * ng * N + nh,
                                 dtype, device),
        "conv_w": conv_w.to(device=device, dtype=dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "A_log": torch.log(torch.arange(1, nh + 1, **f32)),
        "D": torch.ones((nh,), **f32),
        "dt_bias": dt_bias.to(device),
        "norm_w": torch.zeros((di,), dtype=dtype, device=device),
        "out_proj": cm.dense_init(generator, di, d, dtype, device),
    }


def _split_in(cfg: ArchConfig, h):
    """z, xBC, dt of the in-projection h."""
    s, d, di, nh, ng, N = _dims(cfg)
    return h.split([di, di + 2 * ng * N, nh], dim=-1)


def _causal_conv(xBC, w, b):
    """Depthwise causal conv of width K, then SiLU. xBC: (B, S, C); w:
    (K, C)."""
    K, S = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    out = sum(pad[:, i:i + S, :] * w[i] for i in range(K))
    return F.silu(out + b)


def _ssd_chunked(x, dt, A, B, C, chunk: int):
    """The SSD scan. x: (b, S, nh, hd); dt: (b, S, nh); A: (nh,); B, C:
    (b, S, ng, N), all f32. S is padded to a multiple of ``chunk`` (the
    padding has dt = 0: no decay and no input). Returns y (b, S, nh, hd)
    and the final state (b, nh, hd, N)."""
    b, S, nh, hd = x.shape
    ng, N = B.shape[2], B.shape[3]
    rep = nh // ng
    nc = -(-S // chunk)
    Sp = nc * chunk
    if Sp != S:
        x = F.pad(x, (0, 0, 0, 0, 0, Sp - S))
        dt = F.pad(dt, (0, 0, 0, Sp - S))
        B = F.pad(B, (0, 0, 0, 0, 0, Sp - S))
        C = F.pad(C, (0, 0, 0, 0, 0, Sp - S))
    xc = x.reshape(b, nc, chunk, nh, hd)
    dtc = dt.reshape(b, nc, chunk, nh)
    Bc = B.reshape(b, nc, chunk, ng, N)
    Cc = C.reshape(b, nc, chunk, ng, N)
    cum = torch.cumsum(dtc * A, dim=2)                       # (b,nc,Q,nh)
    # intra-chunk: Y[i] = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
    Lmat = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (b,nc,Q,Q,nh)
    iq = torch.arange(chunk, device=x.device)
    causal = (iq[:, None] >= iq[None, :])[None, None, :, :, None]
    Lmat = torch.where(causal, torch.exp(Lmat), torch.zeros_like(Lmat))
    CB = torch.einsum("bcign,bcjgn->bcijg", Cc, Bc)          # (b,nc,Q,Q,ng)
    CB = CB.repeat_interleave(rep, dim=-1)                   # -> nh
    M = CB * Lmat * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bcijh,bcjhd->bcihd", M, xc)
    # chunk states: S_c = sum_j B_j dt_j x_j exp(cum_last - cum_j)
    seg = torch.exp(cum[:, :, -1:, :] - cum)                 # (b,nc,Q,nh)
    Bh = Bc.repeat_interleave(rep, dim=3)                    # (b,nc,Q,nh,N)
    states = torch.einsum("bcqhn,bcqhd->bchdn", Bh * (seg * dtc)[..., None],
                          xc)                                # (b,nc,nh,hd,N)
    # inter-chunk recurrence over the chunk boundary states
    lam = torch.exp(cum[:, :, -1, :])                        # (b,nc,nh)
    h = torch.zeros((b, nh, hd, N), dtype=torch.float32, device=x.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * lam[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)                      # (b,nc,nh,hd,N)
    # inter-chunk contribution: C_i . H_{c-1} * exp(cum_i)
    Ch = Cc.repeat_interleave(rep, dim=3)                    # (b,nc,Q,nh,N)
    y_inter = (torch.einsum("bcqhn,bchdn->bcqhd", Ch, h_prev)
               * torch.exp(cum)[..., None])
    y = (y_intra + y_inter).reshape(b, Sp, nh, hd)[:, :S]
    return y, h


def _gated_out(p, y, z, x_dtype):
    """y (.., di) gated by SiLU(z), rms-normed, projected out."""
    y = cm.rms_norm(y * F.silu(z.float()).to(x_dtype), p["norm_w"])
    return cm.dense(p["out_proj"], y)


def mamba_forward(p, x, cfg: ArchConfig, *, return_state: bool = False):
    """Full-sequence SSD block. x: (B, S, d) -> (B, S, d), and with
    ``return_state`` the decode state {"conv": (B, K-1, conv_dim), "ssm":
    (B, nh, hd, N) f32} after the last position."""
    s, d, di, nh, ng, N = _dims(cfg)
    z, xBC_raw, dt = _split_in(cfg, cm.dense(p["in_proj"], x))
    xBC = _causal_conv(xBC_raw, p["conv_w"], p["conv_b"])
    xin, B, C = xBC.split([di, ng * N, ng * N], dim=-1)
    Bm = B.reshape(*B.shape[:2], ng, N).float()
    Cm = C.reshape(*C.shape[:2], ng, N).float()
    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xin.reshape(*xin.shape[:2], nh, s.head_dim).float()
    y, hT = _ssd_chunked(xh, dt, A, Bm, Cm, s.chunk)
    y = y + xh * p["D"][:, None]
    out = _gated_out(p, y.reshape(*y.shape[:2], di).to(x.dtype), z, x.dtype)
    if not return_state:
        return out
    K = s.conv_width - 1
    tail = xBC_raw[:, -K:, :]
    if tail.shape[1] < K:
        tail = F.pad(tail, (0, 0, K - tail.shape[1], 0))
    return out, {"conv": tail, "ssm": hT}


def init_mamba_state(cfg: ArchConfig, batch: int, dtype, device,
                     lead=()):
    """Zero decode state {"conv": (*lead, B, K-1, conv_dim) in ``dtype``,
    "ssm": (*lead, B, nh, hd, N) f32}."""
    s, d, di, nh, ng, N = _dims(cfg)
    conv_dim = di + 2 * ng * N
    return {"conv": torch.zeros((*lead, batch, s.conv_width - 1, conv_dim),
                                dtype=dtype, device=device),
            "ssm": torch.zeros((*lead, batch, nh, s.head_dim, N),
                               dtype=torch.float32, device=device)}


def mamba_decode(p, x_t, state, cfg: ArchConfig):
    """One-token step. x_t: (B, d) -> (B, d); ``state`` (one layer's
    {"conv", "ssm"}) is advanced in place."""
    s, d, di, nh, ng, N = _dims(cfg)
    z, xBC, dt = _split_in(cfg, cm.dense(p["in_proj"], x_t))
    window = torch.cat([state["conv"], xBC[:, None, :]], dim=1)
    xBC = F.silu((window * p["conv_w"]).sum(dim=1) + p["conv_b"])
    xin, B, C = xBC.split([di, ng * N, ng * N], dim=-1)
    rep = nh // ng
    Bh = B.reshape(-1, ng, N).float().repeat_interleave(rep, dim=1)
    Ch = C.reshape(-1, ng, N).float().repeat_interleave(rep, dim=1)
    dt = F.softplus(dt.float() + p["dt_bias"])               # (B,nh)
    A = -torch.exp(p["A_log"])
    xh = xin.reshape(-1, nh, s.head_dim).float()
    h_new = (state["ssm"] * torch.exp(dt * A)[..., None, None]
             + torch.einsum("bhn,bhd->bhdn", Bh * dt[..., None], xh))
    y = torch.einsum("bhn,bhdn->bhd", Ch, h_new) + xh * p["D"][:, None]
    state["conv"].copy_(window[:, 1:])
    state["ssm"].copy_(h_new)
    return _gated_out(p, y.reshape(-1, di).to(x_t.dtype), z, x_t.dtype)
