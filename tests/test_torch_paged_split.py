"""The split over pages of the port's paged decode kernel
(csrc/paged_decode_attention.cu), on the CPU.

``_paged_split_plain`` mirrors the kernel's two passes: the dense decode's
split mirror (``_decode_split_plain``: per split, each query row's max,
sum and unnormalised accumulator over the split's keys below seq_lens; a
fixed-order combine) over the pages gathered through the table. Here it
is held against the JAX ``paged_decode_attention`` Pallas kernel in
interpret mode and against the port's plain version, on inputs made with
numpy from a seed (f32 and int8 pools; groups 1, 4 and 8; head_dim 64 and
128; seq_lens at 1, the full table and every split edge +-1). The
split-size function ``paged_split`` is checked for reading shapes only and
for cutting the table into whole pages that cover it. The CUDA kernel
itself is held against the plain version on the card by
tests/test_torch_kernels_cuda.py and chip_smoke.py."""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.decode_attention as da
import repro_torch.kernels.decode_attention as tk
from torch_kernel_inputs import pool as _pool
from torch_kernel_inputs import quantize as _quantize
from torch_kernel_inputs import split_edges
from torch_kernel_inputs import t as _t
from torch_kernel_inputs import tables as _tables

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)
HKV, PS, NPP = 2, 8, 6
L = NPP * PS
SPLITS = [PS, 2 * PS, 3 * PS, L]


def _j(a):
    return jnp.asarray(a)


def _inputs(seed, seq_lens, group, dh, quant):
    """Disjoint shuffled tables, pools, queries; int8 pools with their
    scales when quant."""
    rng = np.random.default_rng(seed)
    B = len(seq_lens)
    P = B * NPP + 1
    kp, vp = _pool(rng, P, PS, HKV, dh)
    pt = _tables(rng, B, NPP, P)
    q = rng.standard_normal((B, HKV * group, dh), dtype=np.float32)
    sc = {}
    if quant:
        kp, ksc = _quantize(kp)
        vp, vsc = _quantize(vp)
        sc = dict(k_scale=ksc, v_scale=vsc)
    return q, kp, vp, pt, np.asarray(seq_lens, np.int32), sc


def test_paged_split_is_a_function_of_the_shapes():
    """The split size reads shapes and the SM count only (no seq_lens, so
    no device-to-host sync). At the continuous path's shape (llama3.2-1b:
    B=8, 32 kv heads, group 1, a 576-key table of 16-key pages) the
    128-key cap sets it: 5 splits of 8 pages, 1280 pass-1 blocks."""
    assert list(inspect.signature(tk.paged_split).parameters) == [
        "B", "Hkv", "n_keys", "group", "page_size", "n_sm", "dh"]
    split = tk.paged_split(8, 32, 576, 1, 16, 132)
    assert split == tk.paged_split(8, 32, 576, 1, 16, 132) == 128
    n_split = -(-576 // split)
    assert n_split == 5 and n_split * 32 * 8 == 1280
    # qwen2.5-3b's width on the paged path (group 8, two row tiles of 4)
    assert tk.paged_split(8, 2, 576, 8, 16, 132) == 80


SHAPES = [(8, 32, 576, 1), (8, 2, 576, 8), (1, 1, 16, 1), (1, 2, 576, 8),
          (64, 8, 4096, 4), (3, 4, 300, 2), (16, 8, 640, 3), (2, 1, 17, 64),
          (8, 8, 576, 7)]                           # arctic-480b: group 7


@pytest.mark.parametrize("ps", [1, 5, 16, 256])
@pytest.mark.parametrize("B,Hkv,n_pp_keys,group", SHAPES)
def test_paged_split_whole_pages_cover_the_table(B, Hkv, n_pp_keys, group,
                                                 ps):
    """Splits are whole pages, at least one; ceil(n_keys / split) of them
    cover the table with no empty trailing split; none walks more than
    128 keys' worth of pages (one page where a page is larger); about two
    blocks an SM where the table allows."""
    n_sm = 132
    n_keys = -(-n_pp_keys // ps) * ps               # a whole table of pages
    split = tk.paged_split(B, Hkv, n_keys, group, ps, n_sm)
    n = -(-n_keys // split)
    assert split >= ps and split % ps == 0
    assert n >= 1 and n * split >= n_keys and (n - 1) * split < n_keys
    assert split <= -(-128 // ps) * ps
    units = B * Hkv * -(-group // 4)
    if n_keys >= ps * round(2 * n_sm / units) and units <= n_sm:
        assert units * n >= n_sm // 2


@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("group", [1, 4, 7, 8])
@pytest.mark.parametrize("quant", [False, True])
def test_paged_split_plain_matches_pallas_and_plain(quant, group, dh):
    """At every split size of SPLITS, with seq_lens at 1, the full table
    and each of their edges +-1: the split mirror equals the Pallas kernel
    (interpret mode) and the plain version."""
    lens = sorted(set().union(*(split_edges(L, s) for s in SPLITS)))
    q, kp, vp, pt, lens, sc = _inputs(group + dh, lens, group, dh, quant)
    want = da.paged_decode_attention(_j(q), _j(kp), _j(vp), _j(pt),
                                     _j(lens), interpret=True,
                                     **{k: _j(v) for k, v in sc.items()})
    kw = {k: _t(v) for k, v in sc.items()}
    plain = tk.paged_decode_attention_plain(_t(q), _t(kp), _t(vp), _t(pt),
                                            _t(lens), **kw)
    np.testing.assert_allclose(plain.numpy(), np.asarray(want), **TOL)
    for split in SPLITS:
        got, (m, _, _) = tk._paged_split_plain(_t(q), _t(kp), _t(vp), _t(pt),
                                               _t(lens), split, **kw)
        assert got.shape == q.shape and got.dtype == torch.float32
        assert m.shape == (*q.shape[:2], -(-L // split))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"split {split}")
        np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL,
                                   err_msg=f"split {split}")


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("split", [PS, 2 * PS, 3 * PS])
def test_paged_splits_past_seq_lens_contribute_exactly_zero(split, quant):
    """A split wholly past seq_lens has m = NEG_INF, l = 0, acc = 0, and
    keys past seq_lens do not reach the output: poisoning their pool rows
    leaves it bitwise unchanged; stale table entries past each sequence
    (ids outside the pool read the null page 0) change nothing either."""
    lens = split_edges(L, split)
    q, kp, vp, pt, lens, sc = _inputs(split, lens, 4, 64, quant)
    kw = {k: _t(v) for k, v in sc.items()}
    out, (m, l, acc) = tk._paged_split_plain(_t(q), _t(kp), _t(vp), _t(pt),
                                             _t(lens), split, **kw)
    n_split = m.shape[-1]
    past = (torch.arange(n_split)[None, :] * split
            >= _t(lens)[:, None].long())                    # (B, n_split)
    past = past[:, None, :].expand_as(m)
    assert bool((m[past] == tk.NEG_INF).all())
    assert bool((l[past] == 0).all()) and bool((acc[past] == 0).all())
    assert bool((l[~past] > 0).all())
    stale = pt.copy()
    for b, n in enumerate(lens):
        for k in range(n, L):                   # the sequence's own tail
            kp[pt[b, k // PS], k % PS] = 100 if quant else 1e4
            vp[pt[b, k // PS], k % PS] = -100 if quant else -1e4
        for i in range(-(-int(n) // PS), NPP):
            stale[b, i] = -1 if i % 2 else kp.shape[0] + i
    for table in (pt, stale):
        poisoned, _ = tk._paged_split_plain(_t(q), _t(kp), _t(vp),
                                            _t(table), _t(lens), split, **kw)
        assert torch.equal(out, poisoned)
