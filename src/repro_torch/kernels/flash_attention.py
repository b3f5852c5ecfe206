"""Flash attention (forward) for the H100, with its plain PyTorch version.

``flash_attention`` is the static engine's prefill attention: blocked
online-softmax GQA attention, causal or full, over a prompt whose keys are
its own positions (``S == L``). On a CUDA tensor it launches the
hand-written kernel ``csrc/flash_attention.cu`` (replaces the TPU kernel
``repro/kernels/flash_attention.py::flash_attention``), or raises on what
the kernel does not take; on a CPU tensor it runs the plain version. It
counts its launches in ``flash_attention.launches``, and by KV heads in
``flash_attention.launches_by_heads``. The kernel is forward only: on a
CUDA tensor that needs a gradient (grad mode on) it raises.

Two differences from the TPU kernel: any ``S`` is taken (the Pallas
wrapper asserts block multiples of S and L), and on bf16/f16 inputs the
CUDA kernel rounds the probabilities to the input dtype for its
tensor-core value product, as FlashAttention does. The Pallas kernel and
the plain version keep them in f32 (the Pallas kernel casts ``v`` to f32
before ``p.astype(v.dtype)``, so that cast is to f32). f32 inputs run an
f32 FMA body, with no such rounding.
"""
from __future__ import annotations

import collections
import ctypes
import math

import torch

from repro_torch.kernels.build import kernel
from repro_torch.kernels.decode_attention import (_DTYPE_CODE,
                                                  _attend_rows_plain,
                                                  _check, _on_cuda)

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_float,
                                                          ctypes.c_void_p]


# query rows x keys of the f32 scores a block of the plain version holds
_PLAIN_BLOCK = 1 << 25


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          scale: float = None):
    """Plain PyTorch version: f32 scores, query position c attends keys
    <= c (causal) or all keys, softmax in f32. q: (B, S, H, dh); k, v:
    (B, L, Hkv, dh) -> (B, S, H, dh) in q's dtype. A long prompt is taken
    in blocks of query rows (each row's softmax is its own), so the live
    scores stay under ``_PLAIN_BLOCK`` rows x keys a (sequence, head), not
    S x L: at 32k, 1,024 rows a block."""
    B, S = q.shape[:2]
    L = k.shape[1]
    kf, vf = k.float(), v.float()
    rows = max(1, _PLAIN_BLOCK // L) if S * L > _PLAIN_BLOCK else S
    out = []
    for i in range(0, S, rows):
        c = min(rows, S - i)
        if causal:
            hi = torch.arange(i + 1, i + c + 1, device=q.device)[None]
            hi = hi.expand(B, c)
        else:
            hi = torch.full((B, c), L, device=q.device)
        out.append(_attend_rows_plain(q[:, i:i + c], kf, vf, hi,
                                      scale=scale))
    return out[0] if len(out) == 1 else torch.cat(out, dim=1)


def flash_attention(q, k, v, *, causal: bool = True, scale: float = None):
    """Blocked GQA attention of q (B, S, H, dh) over k, v (B, S, Hkv, dh),
    query head h reading kv head h // (H / Hkv); causal or full. q, k and v
    share one dtype (f32, bf16 or f16). Returns (B, S, H, dh) in q's
    dtype."""
    if not _on_cuda(q):
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        # the kernel has no backward: its output would carry no graph, and
        # the projections before it would silently get no gradient
        raise RuntimeError("flash_attention has no backward: train through "
                           "models.common.attention (models.train_loss "
                           "does), or call it under torch.no_grad()")
    _check(q, k, v, None, None, (), q_ndim=4)
    B, S, H, dh = q.shape
    Hkv = k.shape[2]
    if k.dtype != q.dtype:
        raise ValueError(f"k/v dtype {k.dtype} must be the query's "
                         f"{q.dtype}")
    if k.shape[:2] != (B, S):
        raise ValueError(f"k/v must be (B={B}, S={S}, Hkv, dh) like the "
                         f"queries (S == L), got {tuple(k.shape)}")
    if q.data_ptr() % 16:
        raise ValueError("q must be 16-byte aligned")
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    out = torch.empty_like(q)
    rc = kernel("flash_attention", _ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, H,
        Hkv, dh, _DTYPE_CODE[q.dtype], int(causal), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc:
        raise RuntimeError(f"flash_attention launch failed (rc={rc})")
    # a host counter, run once by a graph capture and never by a replay:
    # serving.graphs restores it after the capture and adds each replay's
    # repro: allow(traced-purity): serving.graphs adds each replay's count
    flash_attention.launches += 1
    flash_attention.launches_by_heads[Hkv] += 1
    return out


flash_attention.launches = 0
flash_attention.launches_by_heads = collections.Counter()
