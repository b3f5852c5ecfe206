"""Seeded numpy inputs for the paged-attention kernel tests (no JAX, so
the card-only tests can use them on a machine without it)."""
import numpy as np
import torch

# the paged entries' libraries (kernels.build.lib_path) as built before the
# dense decode and flash kernels were redesigned: the redesign leaves their
# sources, headers and compiler flags as they were
PAGED_LIBS = {
    "paged_decode_attention": "paged_decode_attention_0fd935ec44eda43a.so",
    "chunk_prefill_attention": "chunk_prefill_attention_724d3abe02686b42.so",
}


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


def verify_window(rng, B, C, npp, ps):
    """Ragged speculative-verify lengths: seq_lens (B,) with room for the
    C-token window in npp pages, n_fed (B,) from 1 to C. Row 0 is an
    inactive slot as the model draft's catch-up feeds it (seq_len 0, one
    fed pad token; its table row should be all null pages)."""
    seq_lens = rng.integers(0, npp * ps - C + 1, size=B).astype(np.int32)
    n_fed = rng.integers(1, C + 1, size=B).astype(np.int32)
    seq_lens[0], n_fed[0] = 0, 1
    return seq_lens, n_fed


def split_edges(L: int, split: int):
    """kv_valid values of 1, L and each boundary of ``split``-key splits
    +-1, within [1, L], sorted."""
    vals = {1, L}
    for edge in range(split, L + 1, split):
        vals.update((edge - 1, edge, edge + 1))
    return sorted(v for v in vals if 1 <= v <= L)
