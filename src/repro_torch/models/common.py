"""Shared PyTorch building blocks of the serving and training paths:
dense layers (with or without a bias), the embedding table, RMSNorm and
LayerNorm, rotary and sinusoidal position embeddings, the SwiGLU
activation, the dense-cache write, the general masked attention (lazy
causal, sliding-window, prefix-LM and full masks, soft-capping, a query
offset and a valid length), the training loss's chunked cross-entropy,
and the dry run's sharding constraints (``constrain``, ``constrain_tree``)
and per-shard attention (``per_shard``), all no-ops on plain tensors.

Parameters are plain dicts of tensors in the reference package's layout
(``dense`` weights are ``(d_in, d_out)`` and apply as ``x @ w``), so weights
move between the two packages unchanged (``models.convert``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint as ckpt
from torch.distributed.tensor import DTensor

# the CPU vector exp guard of the kernels' plain versions (see ``_exp``)
from repro_torch.kernels.decode_attention import _cpu_exp_ready

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


def embed_init(generator: torch.Generator, vocab: int, d: int, dtype,
               device):
    """{"emb": (vocab, d)} drawn Normal(0, 0.02) in f32, then cast."""
    emb = torch.randn((vocab, d), generator=generator, dtype=torch.float32,
                      device=generator.device) * 0.02
    return {"emb": emb.to(device=device, dtype=dtype)}


def rms_norm(x, w, eps: float = 1e-6):
    """RMSNorm in f32 with the ``(1 + w)`` gain; returns x's dtype."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)


def layer_norm(x, w, b, eps: float = 1e-5):
    """LayerNorm in f32 (biased variance); returns x's dtype."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(dt)


def sinusoid(n: int, d: int, device=None):
    """(n, d) f32 sinusoidal positions: sin of the first d/2 angles, then
    their cos (Whisper's encoder table)."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    # the base filled on the device: no host-to-device copy
    ang = pos / torch.pow(torch.full((), 10000.0, device=device), 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


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


def constrain(x, sharding):
    """The reference's ``with_sharding_constraint``: a DTensor ``x`` is
    redistributed to ``sharding`` (a ``sharding.NamedSharding``); without
    a sharding, or on a plain tensor, a no-op."""
    if sharding is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(sharding.mesh, sharding.placements)


def per_shard(fn, q, k, v, *, kv_valid=None, **kw):
    """``fn(q, k, v, **kw)`` (with ``kv_valid=`` when one is given): an
    attention over q (B, S, H, dh) and k, v (B, L, Hkv, dh). On DTensors
    (the dry run) it runs on each rank's shards under ``local_map``, as
    GSPMD partitions the reference's attention as one op: batch split as
    q's is; q's heads split where k's are split alike, where k has one
    head, or where a rank's query heads read whole kv heads (or one) of a
    replicated k, which the rank then slices (Hkv 2 over 4 ranks: each
    rank's 4 of 16 query heads read one kv head); every other dim
    replicated. Traced op by op through DTensor, an uneven head split
    would replicate the batch too, and the blocked softmax's tiles would
    take minutes a layer at 32k."""
    if not isinstance(q, DTensor):
        if kv_valid is not None:
            kw["kv_valid"] = kv_valid
        return fn(q, k, v, **kw)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    H, Hkv = q.shape[2], k.shape[2]
    kpl = k.placements if isinstance(k, DTensor) else \
        (Replicate(),) * mesh.ndim
    qp, kp, heads = [], [], None     # heads: (first, count) a rank slices
    for i, (a, b) in enumerate(zip(q.placements, kpl)):
        h_loc = H // mesh.size(i)
        if isinstance(a, Shard) and a.dim == 0:
            qp.append(Shard(0))
            kp.append(Shard(0))
        elif isinstance(a, Shard) and a.dim == 2 and (
                (isinstance(b, Shard) and b.dim == 2) or Hkv == 1):
            qp.append(Shard(2))
            kp.append(b if isinstance(b, Shard) else Replicate())
        elif (isinstance(a, Shard) and a.dim == 2 and heads is None
              and H % mesh.size(i) == 0
              and (h_loc % (H // Hkv) == 0 or (H // Hkv) % h_loc == 0)):
            n = max(h_loc // (H // Hkv), 1)
            heads = (mesh.get_local_rank(i) * h_loc // (H // Hkv), n)
            qp.append(Shard(2))
            kp.append(Replicate())
        else:
            qp.append(Replicate())
            kp.append(Replicate())
    vb = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
          for p in qp]

    def body(q_, k_, v_, *valid):
        if heads is not None:
            k_, v_ = k_.narrow(2, *heads), v_.narrow(2, *heads)
        if valid:
            return fn(q_, k_, v_, kv_valid=valid[0], **kw)
        return fn(q_, k_, v_, **kw)
    ins, args = (tuple(qp), tuple(kp), tuple(kp)), (q, k, v)
    if kv_valid is not None:
        if not isinstance(kv_valid, DTensor):
            kv_valid = DTensor.from_local(kv_valid, mesh,
                                          [Replicate()] * mesh.ndim,
                                          run_check=False)
        ins, args = ins + (tuple(vb),), args + (kv_valid,)
    return local_map(body, out_placements=list(qp), in_placements=ins,
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def constrain_tree(tree, path_shardings):
    """ZeRO-3 weight gathering: constrain each leaf whose path SUFFIX
    matches an entry of ``path_shardings`` (tuple of (path, sharding)),
    paths as "attn/wq/w". Applied to one layer's params as the layer
    starts, it all-gathers that layer's data-axis weight shards (weight
    bytes) instead of reducing activation-sized partial products."""
    if not path_shardings:
        return tree
    table = dict(path_shardings)

    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, path + (str(k),)) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, path + (str(i),))
                           for i, v in enumerate(t))
        ps = "/".join(path)
        for suffix, sh in table.items():
            if suffix.endswith(ps) or ps.endswith(suffix):
                return constrain(t, sh)
        return t
    return walk(tree, ())


def swiglu(gate, up):
    return F.silu(gate) * up


def update_cache(cache_k, cache_v, k_new, v_new, pos: int):
    """Write k/v (B, S, Hkv, dh) at positions [pos, pos + S) of the dense
    (B, Lmax, Hkv, dh) caches, in place (cast to the caches' dtype). The
    reference's ``dynamic_update_slice`` clamps a start that would run
    past Lmax; here that raises instead."""
    S, L = k_new.shape[1], cache_k.shape[1]
    if not 0 <= pos <= L - S:
        raise ValueError(f"cache write of {S} positions at {pos} runs past "
                         f"the cache length {L}")
    cache_k[:, pos:pos + S] = k_new.to(cache_k.dtype)
    cache_v[:, pos:pos + S] = v_new.to(cache_v.dtype)
    return cache_k, cache_v


# ------------------------------ masks ----------------------------------- #
# The reference's masks (repro/models/common.py), (S, L) True where query i
# may attend key j. ``attention`` builds its masks per block from the same
# rules (``_block_mask``) and never materializes a full (S, L) mask.

def causal_mask(S: int, L: int, q_offset: int = 0):
    qpos = torch.arange(S)[:, None] + q_offset
    return torch.arange(L)[None, :] <= qpos


def sliding_mask(S: int, L: int, window: int, q_offset: int = 0):
    qpos = torch.arange(S)[:, None] + q_offset
    kpos = torch.arange(L)[None, :]
    return (kpos <= qpos) & (kpos > qpos - window)


def prefix_lm_mask(S: int, L: int, prefix_len: int, q_offset: int = 0):
    """Bidirectional over the first ``prefix_len`` positions, causal after."""
    qpos = torch.arange(S)[:, None] + q_offset
    kpos = torch.arange(L)[None, :]
    return (kpos <= qpos) | (kpos < prefix_len)


def length_mask(L: int, valid_len):
    return torch.arange(L)[None, :] < valid_len


# -------------------------- masked attention ---------------------------- #

def _block_mask(kind: str, qpos, kpos, *, window: int = 0,
                prefix_len: int = 0, kv_valid=None):
    """(bq, bkv) mask of query positions ``qpos`` against key positions
    ``kpos``, or (B, bq, bkv) with a (B,) ``kv_valid``."""
    q = qpos[:, None]
    kk = kpos[None, :]
    if kind == "causal":
        m = kk <= q
    elif kind == "sliding":
        m = (kk <= q) & (kk > q - window)
    elif kind == "prefix":
        m = (kk <= q) | (kk < prefix_len)
    elif kind == "full":
        m = torch.ones((q.shape[0], kk.shape[1]), dtype=torch.bool,
                       device=qpos.device)
    else:
        raise ValueError(kind)
    if kv_valid is not None:
        m = m[None] & (kk[None] < kv_valid[:, None, None])
    return m


def _scores_block(qg, kb, scale, softcap):
    """f32 scores (B, S, Hkv, g, L) of grouped queries against a key block,
    times ``scale``, then soft-capped ``tanh(s / cap) * cap``."""
    s = torch.einsum("bshgd,blhd->bshgl", qg.float(), kb.float()) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    return s


def _values(p, v):
    """f32 p (B, S, Hkv, g, L) rounded to V's dtype, times v (B, L, Hkv,
    dv), summed in f32."""
    return torch.einsum("bshgl,blhd->bshgd", p.to(v.dtype).float(), v.float())


def attention(q, k, v, *, mask_kind: str = "causal", window: int = 0,
              prefix_len: int = 0, q_offset: int = 0, kv_valid=None,
              scale: Optional[float] = None, softcap: float = 0.0,
              block_q: int = 512, block_kv: int = 1024):
    """GQA attention with lazy masks: the reference's XLA path
    (``repro.models.common.attention``), in plain PyTorch on any device.

    q: (B, S, H, dh) at positions ``q_offset + [0, S)``; k, v: (B, L, Hkv,
    dh) at positions [0, L); kv_valid: optional (B,) valid key length;
    mask_kind: causal | sliding (``window``) | prefix (``prefix_len``
    bidirectional positions) | full. Scores are f32, scaled, then
    soft-capped when ``softcap``. Counts its calls in ``attention.calls``.

    With ``S * L <= 1 << 21`` one block: a softmax over the masked scores,
    so a fully masked row gets the mean of V. Larger: the blocked online
    softmax over (``block_q``, ``block_kv``) tiles with an f32 accumulator,
    where a masked score contributes 0 and a fully masked row gives 0.
    On DTensors it runs on each rank's shards (``per_shard``)."""
    if isinstance(q, DTensor):
        return per_shard(attention, q, k, v, kv_valid=kv_valid,
                         mask_kind=mask_kind, window=window,
                         prefix_len=prefix_len, q_offset=q_offset,
                         scale=scale, softcap=softcap, block_q=block_q,
                         block_kv=block_kv)
    # a host counter: CUDA-graph capture runs it once, a replay never
    # repro: allow(traced-purity): P1 adds graph replays to the count
    attention.calls += 1
    B, S, H, dh = q.shape
    L, Hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    group = H // Hkv
    dev = q.device
    qg = q.reshape(B, S, Hkv, group, dh)
    if kv_valid is not None:
        kv_valid = kv_valid.to(dev)
    if dev.type == "cpu":
        _cpu_exp_ready()

    if S * L <= 1 << 21:           # small: one block
        s = _scores_block(qg, k, scale, softcap)            # (B,S,Hkv,g,L)
        m = _block_mask(mask_kind, torch.arange(S, device=dev) + q_offset,
                        torch.arange(L, device=dev), window=window,
                        prefix_len=prefix_len, kv_valid=kv_valid)
        m = m[:, :, None, None, :] if m.dim() == 3 else m[None, :, None, None]
        s = torch.where(m, s, torch.full_like(s, NEG_INF))
        out = _values(torch.softmax(s, dim=-1), v)
        return out.reshape(B, S, H, dv).to(q.dtype)

    # blocked online softmax: peak live block (B, bq, Hkv, g, bkv)
    nq, nkv = -(-S // block_q), -(-L // block_kv)
    qp = F.pad(qg, (0, 0, 0, 0, 0, 0, 0, nq * block_q - S))
    kp = F.pad(k, (0, 0, 0, 0, 0, nkv * block_kv - L))
    vp = F.pad(v, (0, 0, 0, 0, 0, nkv * block_kv - L))
    valid = (kv_valid if kv_valid is not None
             else torch.full((B,), L, dtype=torch.int32, device=dev))
    blocks = []
    for i in range(nq):
        qblk = qp[:, i * block_q:(i + 1) * block_q]
        qpos = i * block_q + torch.arange(block_q, device=dev) + q_offset
        m_i = torch.full((B, block_q, Hkv, group), NEG_INF, device=dev)
        l_i = torch.zeros((B, block_q, Hkv, group), device=dev)
        acc = torch.zeros((B, block_q, Hkv, group, dv), device=dev)
        for j in range(nkv):
            kblk = kp[:, j * block_kv:(j + 1) * block_kv]
            vblk = vp[:, j * block_kv:(j + 1) * block_kv]
            s = _scores_block(qblk, kblk, scale, softcap)
            msk = _block_mask(mask_kind, qpos,
                              j * block_kv + torch.arange(block_kv,
                                                          device=dev),
                              window=window, prefix_len=prefix_len,
                              kv_valid=valid)
            s = torch.where(msk[:, :, None, None, :], s,
                            torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m_i, s.amax(dim=-1))
            # a fully masked block: s == m_new == NEG_INF would give exp(0)
            p = torch.where(s <= NEG_INF / 2, torch.zeros_like(s),
                            torch.exp(s - m_new[..., None]))
            corr = torch.exp(torch.clamp_max(m_i - m_new, 0.0))
            l_i = l_i * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + _values(p, vblk)
            m_i = m_new
        blocks.append((acc / torch.clamp_min(l_i, 1e-30)[..., None])
                      .to(q.dtype))
    out = torch.cat(blocks, dim=1)[:, :S]
    return out.reshape(B, S, H, dv)


attention.calls = 0


# ---------------------------- cross-entropy ----------------------------- #

def _xent_chunk(h_c, w, lab_c, tied: bool, ignore: int):
    """(sum of the chunk's NLL, its count of valid labels): f32 logits of
    h_c (B, c, d) against the head ``w``."""
    wf = w.float()
    logits = h_c.float() @ (wf.T if tied else wf)             # (B, c, V)
    valid = lab_c != ignore
    safe = torch.where(valid, lab_c, torch.zeros_like(lab_c)).long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = torch.where(valid, lse - gold, torch.zeros_like(lse))
    return nll.sum(), valid.sum()


def chunked_xent(h, w, labels, *, tied: bool = False, chunk: int = 512,
                 ignore: int = -1):
    """Mean next-token NLL WITHOUT materializing (B, S, V) logits (the
    reference's ``chunked_xent``): a loop over sequence chunks of
    ``chunk`` positions, each under ``torch.utils.checkpoint``, so at most
    one chunk's f32 logits (B, chunk, V) are alive, in the forward and in
    the backward pass. h: (B, S, d) final hidden states; w: (d, V) head or
    (V, d) tied embedding; labels (B, S), ``ignore`` where no loss is
    taken. The sum over valid labels, divided by their count (at least 1)."""
    S = h.shape[1]
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.int64, device=h.device)
    for lo in range(0, S, chunk):
        t, c = ckpt.checkpoint(_xent_chunk, h[:, lo:lo + chunk], w,
                               labels[:, lo:lo + chunk], tied, ignore,
                               use_reentrant=False)
        tot = tot + t
        cnt = cnt + c
    return tot / torch.clamp_min(cnt, 1)
