"""Sequence-sharded decode attention (the reference is
``repro/models/seq_shard_attn.py``).

A decode step writes one token into a LENGTH-sharded KV cache and attends
over it. Each rank owns a contiguous range of the cache's positions: the
new token is written by exactly the rank whose range holds ``pos``; scores
are computed against the local range only; the softmax is combined with
two small all-reduces (the max of the block maxima, then the sum of the
normalizers and of the weighted values). A step's collective traffic is
O(B * H * dh), not O(cache bytes).

The ranks are a ``kernels.sharded.ShardGroup`` (one process a rank, each
holding its slice: ``length_slice``), or the "model" dim of a
``DeviceMesh`` in the dry run, where the cache is a DTensor sharded on its
length and the body runs on rank 0's shards under ``local_map`` (the
reference's ``shard_map``). No kernel runs on this path, as in the
reference, whose body is plain XLA.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.decode_attention import _cpu_exp_ready
from repro_torch.kernels.sharded import ShardGroup, model_axis

NEG_INF = -1e30


def _local_attn_update(q, k_new, v_new, ck, cv, pos: int, axis, *,
                       scale: float, softcap: float, window: int = 0):
    """One rank's body. q: (B, 1, H, dh) replicated; k/v_new: (B, 1, Hkv,
    dh) replicated; ck/cv: (B, Lloc, Hkv, dh), this rank's range of the
    cache, written in place."""
    B, _, H, dh = q.shape
    Lloc, Hkv = ck.shape[1], ck.shape[2]
    base = axis.index * Lloc
    # ---- local write (exactly one rank is in range) ----
    idx = pos - base
    if 0 <= idx < Lloc:
        ck[:, idx] = k_new[:, 0].to(ck.dtype)
        cv[:, idx] = v_new[:, 0].to(cv.dtype)
    if q.device.type == "cpu":
        _cpu_exp_ready()
    # ---- local scores ----
    g = H // Hkv
    qg = q.reshape(B, Hkv, g, dh)
    s = torch.einsum("bhgd,blhd->bhgl", qg.float(), ck.float()) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    kpos = base + torch.arange(Lloc, device=q.device)
    valid = kpos <= pos
    if window:
        valid &= kpos > pos - window
    s = torch.where(valid[None, None, None, :], s, torch.full_like(s, NEG_INF))
    # ---- distributed online softmax ----
    m_glob = axis.reduce(s.amax(dim=-1), "max")                 # (B,Hkv,g)
    p = torch.where(s <= NEG_INF / 2, torch.zeros_like(s),
                    torch.exp(s - m_glob[..., None]))
    l_loc = p.sum(dim=-1)
    o_loc = torch.einsum("bhgl,blhd->bhgd", p.to(cv.dtype).float(),
                         cv.float())
    l_glob = axis.reduce(l_loc, "sum")
    o_glob = axis.reduce(o_loc, "sum")
    out = o_glob / torch.clamp_min(l_glob, 1e-30)[..., None]
    return out.reshape(B, 1, H, dh).to(q.dtype), ck, cv


def decode_attn_seq_sharded(q, k_new, v_new, ck, cv, pos: int, group, *,
                            scale: Optional[float] = None,
                            softcap: float = 0.0, window: int = 0):
    """Write the new token's KV at ``pos`` and attend over the length-
    sharded cache. ``group``: a ``ShardGroup`` (ck/cv are this rank's
    contiguous range, plain tensors; q and the new KV replicated) or a
    ``DeviceMesh`` (every argument a DTensor, the cache sharded on its
    length over "model" and on its batch over the data axes). Returns (out
    (B, 1, H, dh) replicated over the ranks, ck, cv), the cache written in
    place."""
    dh = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    axis = model_axis(group)

    def body(q_, k_, v_, ck_, cv_):
        return _local_attn_update(q_, k_, v_, ck_, cv_, int(pos), axis,
                                  scale=scale, softcap=softcap,
                                  window=window)
    if isinstance(group, ShardGroup):
        return body(q, k_new, v_new, ck, cv)
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.sharding.rules import P, batch_axes, placements
    ba = batch_axes(group)
    rep4 = placements(P(ba, None, None, None), group)
    cache = placements(P(ba, "model", None, None), group)
    fn = local_map(body, out_placements=(rep4, cache, cache),
                   in_placements=(rep4, rep4, rep4, cache, cache),
                   device_mesh=group, redistribute_inputs=True)
    return fn(q, k_new, v_new, ck, cv)


def length_slice(cache, group: ShardGroup):
    """This rank's contiguous range of the length axis of every k/v leaf of
    a dense static cache (``{"stack": {"k", "v"} (L, B, Lmax, Hkv, dh)}``,
    ``"head"`` layers (B, Lmax, Hkv, dh)), as fresh contiguous tensors: the
    rank keeps this much of a replicated prefill's cache. Raises when
    ``Lmax`` does not divide by the group's size."""
    def cut(t):
        L = t.shape[-3]
        if L % group.size:
            raise ValueError(f"cache length {L} does not divide over "
                             f"{group.size} ranks")
        n = L // group.size
        return t.narrow(t.dim() - 3, group.rank * n, n).contiguous()

    def walk(tree):
        if isinstance(tree, dict):
            if "k_scale" in tree:
                raise ValueError("the sequence-sharded path takes a native "
                                 "cache, not int8")
            return {name: (cut(v) if name in ("k", "v") else walk(v))
                    for name, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        return tree
    return walk(cache)
