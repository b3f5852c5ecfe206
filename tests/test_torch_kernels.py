"""The port's paged-attention kernels (repro_torch.kernels.decode_attention)
against the reference Pallas kernels.

On the CPU the wrappers run their plain PyTorch versions; those are held
against the JAX Pallas kernels run in interpret mode, on the same inputs
made with numpy from a seed (f32 and int8 pools, GQA and MHA, ragged
lengths, stale pages, scalar and per-sequence chunk start). The CUDA
kernels themselves are held against the plain versions on the card by
tests/test_torch_kernels_cuda.py and by chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.decode_attention as da
import repro_torch.kernels.decode_attention as tk
from torch_kernel_inputs import pool as _pool
from torch_kernel_inputs import quantize as _quantize
from torch_kernel_inputs import t as _t
from torch_kernel_inputs import tables as _tables

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)


def _j(a):
    return jnp.asarray(a)


# ------------------------------- decode --------------------------------- #

@pytest.mark.parametrize("B,H,Hkv,dh,ps,npp,quant", [
    (3, 8, 2, 64, 16, 8, False),     # GQA 4:1
    (4, 4, 4, 64, 8, 6, False),      # MHA, small pages
    (2, 4, 1, 128, 32, 4, False),    # MQA, wide heads
    (3, 8, 2, 64, 16, 6, True),      # GQA, int8 pool
    (2, 4, 4, 16, 4, 5, True),       # MHA, int8, the reduced model's width
])
def test_paged_decode_plain_matches_pallas(B, H, Hkv, dh, ps, npp, quant):
    rng = np.random.default_rng(0)
    P = B * npp + 1
    q = rng.standard_normal((B, H, dh), dtype=np.float32)
    kp, vp = _pool(rng, P, ps, Hkv, dh)
    pt = _tables(rng, B, npp, P)
    lens = rng.integers(1, npp * ps + 1, size=B).astype(np.int32)
    kw_j, kw_t = {}, {}
    if quant:
        kp, ksc = _quantize(kp)
        vp, vsc = _quantize(vp)
        kw_j = dict(k_scale=_j(ksc), v_scale=_j(vsc))
        kw_t = dict(k_scale=_t(ksc), v_scale=_t(vsc))
    want = da.paged_decode_attention(_j(q), _j(kp), _j(vp), _j(pt),
                                     _j(lens), interpret=True, **kw_j)
    got = tk.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(pt), _t(lens),
                                    **kw_t)
    assert got.dtype == torch.float32 and got.shape == (B, H, dh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_paged_decode_plain_ignores_stale_pages():
    """Table entries past seq_len (the null page) and unowned pages are
    inert, in both the reference kernel and the port's plain version."""
    rng = np.random.default_rng(1)
    B, H, Hkv, dh, ps, npp = 2, 8, 2, 64, 8, 5
    P = 16
    q = rng.standard_normal((B, H, dh), dtype=np.float32)
    kp, vp = _pool(rng, P, ps, Hkv, dh)
    pt = _tables(rng, B, npp, P, stale=2)
    lens = np.asarray([13, 21], np.int32)           # inside the 3 real pages
    got = tk.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(pt), _t(lens))
    want = da.paged_decode_attention(_j(q), _j(kp), _j(vp), _j(pt), _j(lens),
                                     interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    poisoned_k, poisoned_v = kp.copy(), vp.copy()
    owned = np.zeros(P, bool)
    owned[pt[pt > 0]] = True
    poisoned_k[~owned] = 999.0
    poisoned_v[~owned] = -999.0
    for b in range(B):                               # tail past seq_len
        last = pt[b, (lens[b] - 1) // ps]
        poisoned_k[last, lens[b] % ps or ps:] = 777.0
    got2 = tk.paged_decode_attention(_t(q), _t(poisoned_k), _t(poisoned_v),
                                     _t(pt), _t(lens))
    np.testing.assert_allclose(got2.numpy(), got.numpy(), atol=1e-6)


# ---------------------------- chunk prefill ----------------------------- #

@pytest.mark.parametrize("B,H,Hkv,dh,ps,C,start,real,quant", [
    (1, 8, 2, 64, 16, 32, 0, 32, False),     # first chunk, GQA
    (1, 4, 1, 128, 16, 32, 32, 20, False),   # later chunk, padded, MQA
    (2, 4, 4, 64, 8, 16, 8, 16, False),      # MHA, mid-page start
    (1, 8, 2, 64, 32, 16, 32, 16, True),     # GQA, int8 pool
    (2, 4, 4, 16, 4, 8, 4, 5, True),         # MHA, int8, reduced width
])
def test_chunk_prefill_plain_matches_pallas(B, H, Hkv, dh, ps, C, start,
                                            real, quant):
    rng = np.random.default_rng(2)
    npp = (start + C) // ps + 2
    P = B * npp + 1
    q = rng.standard_normal((B, C, H, dh), dtype=np.float32)
    kp, vp = _pool(rng, P, ps, Hkv, dh)
    pt = _tables(rng, B, npp, P)
    nv = np.full((B,), start + real, np.int32)
    kw_j, kw_t = {}, {}
    if quant:
        kp, ksc = _quantize(kp)
        vp, vsc = _quantize(vp)
        kw_j = dict(k_scale=_j(ksc), v_scale=_j(vsc))
        kw_t = dict(k_scale=_t(ksc), v_scale=_t(vsc))
    want = da.chunk_prefill_attention(_j(q), _j(kp), _j(vp), _j(pt), start,
                                      _j(nv), interpret=True, **kw_j)
    got = tk.chunk_prefill_attention(_t(q), _t(kp), _t(vp), _t(pt), start,
                                     _t(nv), **kw_t)
    assert got.shape == (B, C, H, dh)
    # every row, the right-padding rows included (they attend up to n_valid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("quant", [False, True])
def test_chunk_prefill_plain_vector_start(quant):
    """A (B,) start — per-sequence windows, as speculative verify uses the
    kernel — matches the reference kernel row for row."""
    rng = np.random.default_rng(3)
    B, C, H, Hkv, dh, ps, npp = 3, 8, 8, 2, 64, 8, 6
    P = B * npp + 1
    q = rng.standard_normal((B, C, H, dh), dtype=np.float32)
    kp, vp = _pool(rng, P, ps, Hkv, dh)
    pt = _tables(rng, B, npp, P)
    start = np.asarray([0, 13, 30], np.int32)
    nv = start + np.asarray([8, 5, 1], np.int32)
    kw_j, kw_t = {}, {}
    if quant:
        kp, ksc = _quantize(kp)
        vp, vsc = _quantize(vp)
        kw_j = dict(k_scale=_j(ksc), v_scale=_j(vsc))
        kw_t = dict(k_scale=_t(ksc), v_scale=_t(vsc))
    want = da.chunk_prefill_attention(_j(q), _j(kp), _j(vp), _j(pt),
                                      _j(start), _j(nv), interpret=True,
                                      **kw_j)
    got = tk.chunk_prefill_attention(_t(q), _t(kp), _t(vp), _t(pt),
                                     _t(start), _t(nv), **kw_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # a scalar start equals the same start broadcast as a (B,) tensor
    s_scalar = tk.chunk_prefill_attention(_t(q), _t(kp), _t(vp), _t(pt), 13,
                                          _t(nv), **kw_t)
    s_vec = tk.chunk_prefill_attention(_t(q), _t(kp), _t(vp), _t(pt),
                                       torch.full((B,), 13, dtype=torch.int32),
                                       _t(nv), **kw_t)
    assert torch.equal(s_scalar, s_vec)


def test_decode_is_one_position_chunk():
    """Decode attention equals a one-position chunk at seq_len - 1: the
    identity the two CUDA kernels' shared body relies on."""
    rng = np.random.default_rng(4)
    B, H, Hkv, dh, ps, npp = 3, 8, 2, 64, 8, 4
    P = B * npp + 1
    q = rng.standard_normal((B, H, dh), dtype=np.float32)
    kp, vp = _pool(rng, P, ps, Hkv, dh)
    pt = _tables(rng, B, npp, P)
    lens = np.asarray([1, 17, 32], np.int32)
    dec = tk.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(pt), _t(lens))
    chk = tk.chunk_prefill_attention(_t(q)[:, None], _t(kp), _t(vp), _t(pt),
                                     _t(lens - 1), _t(lens))
    np.testing.assert_allclose(chk[:, 0].numpy(), dec.numpy(), atol=1e-6)


# ------------------------ wrapper contract (CPU) ------------------------ #

def test_cpu_tensors_take_the_plain_version_and_do_not_count():
    rng = np.random.default_rng(5)
    q = _t(rng.standard_normal((1, 4, 64), dtype=np.float32))
    kp, vp = (_t(a) for a in _pool(rng, 3, 8, 4, 64))
    pt = torch.tensor([[1, 2]], dtype=torch.int32)
    lens = torch.tensor([9], dtype=torch.int32)
    n_dec = tk.paged_decode_attention.launches
    n_chk = tk.chunk_prefill_attention.launches
    tk.paged_decode_attention(q, kp, vp, pt, lens)
    tk.chunk_prefill_attention(q[:, None], kp, vp, pt, 8, lens)
    assert tk.paged_decode_attention.launches == n_dec
    assert tk.chunk_prefill_attention.launches == n_chk


@pytest.mark.parametrize("bad", ["head_dim", "q_dtype", "scales", "index",
                                 "heads"])
def test_kernel_argument_check_rejects(bad):
    """What the CUDA kernels do not take raises before any launch (the
    check runs on CPU tensors here; on the card it guards the launch)."""
    q = torch.zeros((2, 8, 64))
    kp = torch.zeros((5, 16, 2, 64))
    ksc = vsc = None
    pt = torch.zeros((2, 3), dtype=torch.int32)
    lens = torch.ones((2,), dtype=torch.int32)
    if bad == "head_dim":
        q, kp = torch.zeros((2, 8, 16)), torch.zeros((5, 16, 2, 16))
    elif bad == "q_dtype":
        q = q.double()
    elif bad == "scales":
        kp = kp.to(torch.int8)            # int8 pool without scales
    elif bad == "index":
        lens = lens.long()
    elif bad == "heads":
        kp = torch.zeros((5, 16, 3, 64))
    with pytest.raises(ValueError):
        tk._check(q, kp, kp.clone(), ksc, vsc, (pt, lens), q_ndim=3)


def test_kernel_argument_check_accepts_path_shapes():
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        q = torch.zeros((8, 32, 64), dtype=dt)
        for pool_dt in (dt, torch.int8):
            kp = torch.zeros((289, 16, 32, 64), dtype=pool_dt)
            sc = (torch.ones(32) if pool_dt == torch.int8 else None)
            tk._check(q, kp, kp.clone(), sc, sc, (
                torch.zeros((8, 36), dtype=torch.int32),
                torch.ones((8,), dtype=torch.int32)), q_ndim=3)


def test_build_is_keyed_by_the_sources():
    """Each kernel library's name carries a hash of its source, the shared
    headers and the compiler flags, so an edited source rebuilds."""
    for name in tk._SOURCES:
        path = tk._lib_path(name)
        assert path.parent == tk._BUILD and path.suffix == ".so"
        assert path.name.startswith(name + "_")
    assert tk._source_hash("paged_decode_attention") != tk._source_hash(
        "chunk_prefill_attention")
    assert "arch=compute_90a,code=sm_90a" in tk._NVCC_FLAGS
