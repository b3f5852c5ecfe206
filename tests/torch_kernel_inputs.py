"""Seeded numpy inputs for the paged-attention kernel tests (no JAX, so
the card-only tests can use them on a machine without it)."""
import numpy as np
import torch

# the paged decode library (kernels.build.lib_path) before its redesign
# (split over pages, a decode body of its own)
OLD_PAGED_DECODE_LIB = "paged_decode_attention_0fd935ec44eda43a.so"
# the headers the redesigned paged decode is built from: the shared dtype
# codes and numerics, and the split-K combine it shares with the dense
# decode and the chunk kernel
PAGED_DECODE_HEADERS = {"dispatch.cuh", "paged_attention.cuh",
                        "split_decode.cuh"}
# the chunk library before its redesign on tensor-core tiles
OLD_CHUNK_LIB = "chunk_prefill_attention_724d3abe02686b42.so"
# the headers the redesigned chunk kernel is built from: the tensor-core
# tiles it shares with flash and the split-K combine it shares with the
# dense decode
CHUNK_HEADERS = {"dispatch.cuh", "paged_attention.cuh", "mma_tile.cuh",
                 "split_decode.cuh"}


# arctic-480b's attention width (H, Hkv, dh): 56 query heads over 8 KV
# heads, GQA group 7 (odd and no power of two: the paged decode tiles a
# group's rows 4 + 3, the tensor-core tiles hold 16 // 7 positions)
ARCTIC_WIDTH = (56, 8, 128)
# llava15-13b's (MHA: 40 query heads over 40 KV heads, group 1) and
# paligemma-3b's (8 query heads over 1 KV head, head width 256)
LLAVA_WIDTH = (40, 40, 128)
PALIGEMMA_WIDTH = (8, 1, 256)
# gemma3-1b's (4 query heads over 1 KV head, head width 256: group 4)
GEMMA3_WIDTH = (4, 1, 256)
# paligemma-3b's Gemma-2B decoder served as a text-only causal LM
# (``cfg.replace(**PALI_TEXT)``): the one derivation of a config file that
# the paged path and flash reach at head width 256
PALI_TEXT = dict(family="dense", prefix_len=0, prefix_bidirectional=False)
# the same decoder with its 8 heads of 256 regrouped as 4 query heads of
# 512 over its 1 KV head: the width no config of the repo reaches, served
# at 512 (head widths 384 and 512 of the kernels)
WIDE_TEXT = dict(PALI_TEXT, n_heads=4, head_dim=512)


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


def chunk_edges(split: int, C: int, n_keys: int):
    """(start, n_valid) of chunks of C positions against ``n_keys`` table
    keys whose last row's frontier falls one key before, on and one key
    past a split edge (the last two right-padded, n_valid < start + C),
    and a chunk at 0."""
    edge = min(split, n_keys - 1)
    starts = [0] + [min(max(edge - C + d, 0), n_keys - C) for d in (-1, 0, 1)]
    n_valid = [C, starts[1] + C, starts[2] + C - 3, starts[3] + C - 1]
    return np.asarray(starts, np.int32), np.asarray(n_valid, np.int32)
