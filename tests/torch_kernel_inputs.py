"""Seeded numpy inputs for the paged-attention kernel tests (no JAX, so
the card-only tests can use them on a machine without it)."""
import numpy as np
import torch


def t(a):
    """numpy -> a torch tensor that owns a copy of the data."""
    return torch.from_numpy(np.array(a, copy=True))


def pool(rng, P, ps, Hkv, dh):
    """Random f32 K and V pools of P pages."""
    return (rng.standard_normal((P, ps, Hkv, dh), dtype=np.float32),
            rng.standard_normal((P, ps, Hkv, dh), dtype=np.float32))


def quantize(x):
    """Per-kv-head symmetric int8, as the reference's quantize_kv."""
    amax = np.maximum(np.abs(x).max(axis=(0, 1, 3)), 1e-6)
    scale = (amax / 127.0).astype(np.float32)
    q = np.clip(np.round(x / scale[None, None, :, None]), -127, 127)
    return q.astype(np.int8), scale


def tables(rng, B, npp, P, stale: int = 0):
    """Shuffled disjoint pages (ids >= 1); ``stale`` trailing entries per
    row point at the null page 0."""
    perm = rng.permutation(P - 1)[:B * npp].reshape(B, npp) + 1
    if stale:
        perm[:, npp - stale:] = 0
    return perm.astype(np.int32)
