"""The split over keys of the port's chunk kernel
(csrc/chunk_prefill_attention.cu on its tensor-core tiles), on the CPU.

``_chunk_split_plain`` mirrors the kernel's two passes: per split, each
query row's max, sum and unnormalised accumulator over the split's keys up
to the row's frontier, with the kernel's int8 scale folding (integer dots
times ``scale * k_scale``, integer sums times ``v_scale``); then the
fixed-order combine of ``split_decode.cuh``. Here it is held against the
JAX ``chunk_prefill_attention`` and ``spec_verify_attention`` Pallas
kernels in interpret mode, on inputs made with numpy from a seed (f32 and
int8 pools; groups 1, 4 and 8; chunk starts and valid lengths on and
beside split edges; right-padded chunks; verify windows with fewer fed
tokens than rows and an inactive row on a table of null pages). The
split-size function ``chunk_split`` is checked for covering the table from
the shapes alone. The CUDA kernel itself is held against the plain version
on the card by tests/test_torch_kernels_cuda.py and chip_smoke.py."""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.decode_attention as da
import repro_torch.kernels.decode_attention as tk
from torch_kernel_inputs import chunk_edges
from torch_kernel_inputs import pool as _pool
from torch_kernel_inputs import quantize as _quantize
from torch_kernel_inputs import t as _t
from torch_kernel_inputs import tables as _tables
from torch_kernel_inputs import verify_window as _verify_window

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)
HKV, DH, PS, NPP, C = 2, 32, 8, 6, 8
L = NPP * PS


def _j(a):
    return jnp.asarray(a)


def _pools(rng, B, group, quant):
    """Pools, tables and queries of B sequences at the given group; int8
    pools with their scales when quant."""
    P = B * NPP + 1
    kp, vp = _pool(rng, P, PS, HKV, DH)
    pt = _tables(rng, B, NPP, P)
    q = rng.standard_normal((B, C, HKV * group, DH), dtype=np.float32)
    sc = {}
    if quant:
        kp, ksc = _quantize(kp)
        vp, vsc = _quantize(vp)
        sc = dict(k_scale=ksc, v_scale=vsc)
    return q, kp, vp, pt, sc


SPLITS = [8, 16, 24, 40, L, L + 8]


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("group", [1, 4, 7, 8])
@pytest.mark.parametrize("split", SPLITS)
def test_chunk_split_plain_matches_pallas(split, group, quant):
    rng = np.random.default_rng(split + group)
    start, nv = chunk_edges(split, C, L)
    q, kp, vp, pt, sc = _pools(rng, len(start), group, quant)
    want = da.chunk_prefill_attention(_j(q), _j(kp), _j(vp), _j(pt), _j(start),
                                      _j(nv), interpret=True,
                                      **{k: _j(v) for k, v in sc.items()})
    kw = {k: _t(v) for k, v in sc.items()}
    got, (m, _, _) = tk._chunk_split_plain(_t(q), _t(kp), _t(vp), _t(pt),
                                           _t(start), _t(nv), split, **kw)
    plain = tk.chunk_prefill_attention_plain(_t(q), _t(kp), _t(vp), _t(pt),
                                             _t(start), _t(nv), **kw)
    assert got.shape == q.shape and got.dtype == torch.float32
    assert m.shape == (*q.shape[:3], -(-L // split))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("group", [1, 4, 7, 8])
@pytest.mark.parametrize("split", [8, 16])
def test_verify_split_plain_matches_pallas(split, group, quant):
    """The verify window: per-sequence start, fewer fed tokens than rows,
    row 0 inactive (seq_len 0, one fed token) on a table of null pages; a
    sequence's window crossing a split edge."""
    rng = np.random.default_rng(10 * split + group)
    B = 4
    q, kp, vp, pt, sc = _pools(rng, B, group, quant)
    seq_lens, n_fed = _verify_window(rng, B, C, NPP, PS)
    pt[0] = 0
    seq_lens[1], n_fed[1] = split - 3, C             # the window spans the edge
    seq_lens[2], n_fed[2] = split - 1, 2             # two fed rows, six pad rows
    want = da.spec_verify_attention(_j(q), _j(kp), _j(vp), _j(pt),
                                    _j(seq_lens), _j(n_fed), interpret=True,
                                    **{k: _j(v) for k, v in sc.items()})
    kw = {k: _t(v) for k, v in sc.items()}
    got, _ = tk._chunk_split_plain(_t(q), _t(kp), _t(vp), _t(pt),
                                   _t(seq_lens), _t(seq_lens + n_fed), split,
                                   **kw)
    plain = tk.spec_verify_attention_plain(_t(q), _t(kp), _t(vp), _t(pt),
                                           _t(seq_lens), _t(n_fed), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("split", [8, 16, 24])
def test_splits_past_the_frontier_contribute_exactly_zero(split, quant):
    """A split wholly past a row's frontier has m = NEG_INF, l = 0, acc =
    0; a live one has l > 0; keys past every frontier do not reach the
    output: poisoning them leaves it bitwise unchanged."""
    rng = np.random.default_rng(split)
    start, nv = chunk_edges(split, C, L)
    q, kp, vp, pt, sc = _pools(rng, len(start), 4, quant)
    kw = {k: _t(v) for k, v in sc.items()}
    out, (m, l, acc) = tk._chunk_split_plain(
        _t(q), _t(kp), _t(vp), _t(pt), _t(start), _t(nv), split, **kw)
    n_split = m.shape[-1]
    frontier = np.minimum(start[:, None] + np.arange(C) + 1, nv[:, None])
    past = (torch.arange(n_split)[None, None, :] * split
            >= _t(frontier)[..., None].long())             # (B, C, n_split)
    past = past[:, :, None, :].expand_as(m)
    assert bool(past.any()) and bool((~past).any())
    assert bool((m[past] == tk.NEG_INF).all())
    assert bool((l[past] == 0).all()) and bool((acc[past] == 0).all())
    assert bool((l[~past] > 0).all())
    for b in range(len(start)):             # every key past the last frontier
        for kpos in range(int(frontier[b].max()), L):
            page, off = pt[b, kpos // PS], kpos % PS
            kp[page, off] = 100 if quant else 1e4
            vp[page, off] = -100 if quant else -1e4
    poisoned, _ = tk._chunk_split_plain(_t(q), _t(kp), _t(vp), _t(pt),
                                        _t(start), _t(nv), split, **kw)
    assert torch.equal(out, poisoned)


@pytest.mark.parametrize("quant", [False, True])
def test_kernel_splits_match_pallas(quant):
    """The split sizes the kernel takes at these shapes (one and several
    splits, 16- and 64-row tiles) give the reference's result."""
    rng = np.random.default_rng(7)
    start, nv = chunk_edges(16, C, L)
    for group, n_sm in ((1, 132), (8, 132), (1, 1), (8, 1)):
        q, kp, vp, pt, sc = _pools(rng, len(start), group, quant)
        split = tk.chunk_split(len(start), HKV, C, group, L, n_sm)
        want = da.chunk_prefill_attention(
            _j(q), _j(kp), _j(vp), _j(pt), _j(start), _j(nv), interpret=True,
            **{k: _j(v) for k, v in sc.items()})
        got, _ = tk._chunk_split_plain(
            _t(q), _t(kp), _t(vp), _t(pt), _t(start), _t(nv), split,
            **{k: _t(v) for k, v in sc.items()})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


SHAPES = [(1, 32, 64, 1, 576), (8, 32, 5, 1, 576), (8, 8, 5, 4, 576),
          (8, 2, 5, 8, 576), (1, 2, 64, 8, 576), (4, 8, 64, 4, 576),
          (1, 1, 1, 1, 16), (16, 32, 8, 1, 4096), (2, 2, 8, 8, 48),
          (64, 8, 64, 4, 8192)]


@pytest.mark.parametrize("B,Hkv,Cc,group,n_keys", SHAPES)
@pytest.mark.parametrize("n_sm", [132, 114])
def test_chunk_split_covers_the_table(B, Hkv, Cc, group, n_keys, n_sm):
    """Whole stages (32 keys with 64-row tiles, 64 with 16-row tiles), at
    most four of them; the splits cover the table with no empty trailing
    split; at least a block an SM where the table allows."""
    split = tk.chunk_split(B, Hkv, Cc, group, n_keys, n_sm)
    rows = Cc * group
    bm, sk = (16, 64) if rows <= 16 else (64, 32)
    n = -(-n_keys // split)
    assert split % sk == 0 and sk <= split <= 4 * sk
    assert n >= 1 and n * split >= n_keys and (n - 1) * split < n_keys
    units = B * Hkv * -(-rows // bm)
    if n_keys >= sk * max(1, round(2 * n_sm / units)):
        assert units * n >= n_sm


def test_chunk_split_is_a_function_of_the_shapes():
    """The split size reads shapes and the SM count only (no start,
    n_valid, seq_lens or n_fed, so no device-to-host sync); the
    continuous path's chunk and verify shapes fill the card."""
    assert list(inspect.signature(tk.chunk_split).parameters) == [
        "B", "Hkv", "C", "group", "n_keys", "n_sm"]
    chunk = tk.chunk_split(1, 32, 64, 1, 576, 132)
    assert chunk == tk.chunk_split(1, 32, 64, 1, 576, 132) == 96
    assert 32 * -(-576 // chunk) >= 132
    verify = tk.chunk_split(8, 32, 5, 1, 576, 132)
    assert verify == 192 and 8 * 32 * -(-576 // verify) >= 132
    assert tk.chunk_on_tensor_cores(torch.bfloat16, torch.int8)
    assert tk.chunk_on_tensor_cores(torch.float16, torch.float16)
    assert not tk.chunk_on_tensor_cores(torch.float32, torch.float32)
    assert not tk.chunk_on_tensor_cores(torch.bfloat16, torch.float32)
