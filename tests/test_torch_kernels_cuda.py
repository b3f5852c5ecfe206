"""The port's CUDA kernels (paged decode, chunk prefill, speculative
verify, dense decode, flash attention) against their plain PyTorch
versions, on the card; the tensor-core kernels (flash, and the chunk on
bf16/f16/int8 pools) within 2e-2, because they round the probabilities to
the input dtype for the value product where the plain versions keep them
in f32, and their f32 paths within 1e-4. Needs an NVIDIA GPU and nvcc (the
kernels have no CPU mode), so every test here is marked ``cuda`` and skips
without a card; the file imports no JAX, so it runs on a machine that has
none:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

import repro_torch.kernels.decode_attention as tk
import repro_torch.kernels.flash_attention as tkf
from repro_torch.kernels import build as kbuild
from repro_torch.configs import get_config
from repro_torch.configs.reduce import reduced
from repro_torch.models import moe as tmoe
from repro_torch.models.lm import init_params
from torch_kernel_inputs import ARCTIC_WIDTH
from torch_kernel_inputs import CHUNK_HEADERS
from torch_kernel_inputs import GEMMA3_WIDTH
from torch_kernel_inputs import LLAVA_WIDTH
from torch_kernel_inputs import OLD_PAGED_DECODE_LIB
from torch_kernel_inputs import PAGED_DECODE_HEADERS
from torch_kernel_inputs import PALIGEMMA_WIDTH
from torch_kernel_inputs import chunk_edges
from torch_kernel_inputs import pool as _pool
from torch_kernel_inputs import quantize as _quantize
from torch_kernel_inputs import split_edges
from torch_kernel_inputs import t as _t
from torch_kernel_inputs import tables as _tables
from torch_kernel_inputs import verify_window as _verify_window

torch.set_num_threads(2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,quant", [(torch.float32, False),
                                         (torch.bfloat16, False),
                                         (torch.bfloat16, True)])
def test_cuda_kernels_match_plain(cuda_device, dtype, quant):
    rng = np.random.default_rng(6)
    B, H, Hkv, dh, ps, npp, C = 3, 8, 2, 64, 16, 8, 32
    P = B * npp + 1
    kp, vp = _pool(rng, P, ps, Hkv, dh)
    kw = {}
    if quant:
        kp, ksc = _quantize(kp)
        vp, vsc = _quantize(vp)
        kw = dict(k_scale=_t(ksc).to(cuda_device),
                  v_scale=_t(vsc).to(cuda_device))
    dev = dict(device=cuda_device)
    kpt = _t(kp).to(**dev) if quant else _t(kp).to(dtype=dtype, **dev)
    vpt = _t(vp).to(**dev) if quant else _t(vp).to(dtype=dtype, **dev)
    pt = _t(_tables(rng, B, npp, P)).to(**dev)
    lens = _t(rng.integers(1, npp * ps + 1, size=B).astype(np.int32)).to(**dev)
    q = _t(rng.standard_normal((B, H, dh), dtype=np.float32)).to(
        dtype=dtype, **dev)
    tol = 1e-4 if dtype == torch.float32 and not quant else 2e-2
    got = tk.paged_decode_attention(q, kpt, vpt, pt, lens, **kw)
    want = tk.paged_decode_attention_plain(q, kpt, vpt, pt, lens, **kw)
    assert float((got.float() - want.float()).abs().max()) <= tol
    qc = _t(rng.standard_normal((B, C, H, dh), dtype=np.float32)).to(
        dtype=dtype, **dev)
    nv = torch.full((B,), 40, dtype=torch.int32, **dev)
    got = tk.chunk_prefill_attention(qc, kpt, vpt, pt, 8, nv, **kw)
    want = tk.chunk_prefill_attention_plain(qc, kpt, vpt, pt, 8, nv, **kw)
    assert float((got.float() - want.float()).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 2, 5, 8])
@pytest.mark.parametrize("Hkv", [8, 2])
@pytest.mark.parametrize("dtype,quant", [(torch.float32, False),
                                         (torch.bfloat16, False),
                                         (torch.bfloat16, True)])
def test_cuda_spec_verify_matches_plain(cuda_device, dtype, quant, Hkv, C):
    """The verify windows of spec_k 4 and 7 (C = 1, 2, 5, 8), ragged fed
    lengths, an inactive row on the null page, group 1 and 4."""
    rng = np.random.default_rng(C)
    B, H, dh, ps, npp = 4, 8, 64, 16, 6
    P = B * npp + 1
    kp, vp = _pool(rng, P, ps, Hkv, dh)
    kw = {}
    if quant:
        kp, ksc = _quantize(kp)
        vp, vsc = _quantize(vp)
        kw = dict(k_scale=_t(ksc).to(cuda_device),
                  v_scale=_t(vsc).to(cuda_device))
    dev = dict(device=cuda_device)
    kpt = _t(kp).to(**dev) if quant else _t(kp).to(dtype=dtype, **dev)
    vpt = _t(vp).to(**dev) if quant else _t(vp).to(dtype=dtype, **dev)
    pt = _tables(rng, B, npp, P)
    pt[0] = 0
    lens, fed = (_t(a).to(**dev) for a in _verify_window(rng, B, C, npp, ps))
    q = _t(rng.standard_normal((B, C, H, dh), dtype=np.float32)).to(
        dtype=dtype, **dev)
    tol = 1e-4 if dtype == torch.float32 and not quant else 2e-2
    n = tk.spec_verify_attention.launches
    got = tk.spec_verify_attention(q, kpt, vpt, _t(pt).to(**dev), lens, fed,
                                   **kw)
    want = tk.spec_verify_attention_plain(q, kpt, vpt, _t(pt).to(**dev),
                                          lens, fed, **kw)
    torch.cuda.synchronize()
    assert tk.spec_verify_attention.launches == n + 1
    assert float((got.float() - want.float()).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["bfloat16", "int8"])
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("B", [8, 2])
def test_cuda_head_shard_bitwise_equal_to_whole_pool(cuda_device, B, n,
                                                     pool):
    """Head-sharded serving's kernel calls: each of the three paged entries
    called with a shard's heads of q and of the pool (and its scales) and
    the whole pool's KV-head count for its split gives bitwise the
    matching heads of the whole call, at llama3.2-1b's width (32 heads of
    64 over 32 KV heads, page 16, 36 pages a sequence): a decode step, a
    64-token chunk at 384 and a C=5 verify window, at B=8 and B=2. The
    shard's own head count would split the chunk's keys otherwise, and at
    B=2 the decode's and the verify window's too."""
    rng = np.random.default_rng(20 + n + B)
    H = Hkv = 32
    dh, ps, npp = 64, 16, 36
    P = B * npp + 1
    dev = dict(device=cuda_device)
    kp, vp = _pool(rng, P, ps, Hkv, dh)
    ksc = vsc = None
    if pool == "int8":
        kp, ksc = _quantize(kp)
        vp, vsc = _quantize(vp)
        ksc, vsc = _t(ksc).to(**dev), _t(vsc).to(**dev)
    kpt = _t(kp).to(dtype=getattr(torch, pool), **dev)
    vpt = _t(vp).to(dtype=getattr(torch, pool), **dev)
    pt = _t(_tables(rng, B, npp, P)).to(**dev)
    lens = _t(rng.integers(1, npp * ps + 1, size=B).astype(np.int32)).to(**dev)
    vl, fed = (_t(a).to(**dev) for a in _verify_window(rng, B, 5, npp, ps))

    def q(*shape):
        return _t(rng.standard_normal(shape, dtype=np.float32)).to(
            dtype=torch.bfloat16, **dev)
    qd, qc, qv = q(B, H, dh), q(1, 64, H, dh), q(B, 5, H, dh)
    nv = torch.tensor([430], dtype=torch.int32, **dev)
    calls = [
        (tk.paged_decode_attention, 1, qd, (pt, lens)),
        (tk.chunk_prefill_attention, 2, qc, (pt[:1], 384, nv)),
        (tk.spec_verify_attention, 2, qv, (pt, vl, fed))]
    n_sm = tk._sm_count(torch.cuda.current_device())
    assert (tk.chunk_split(1, Hkv // n, 64, 1, npp * ps, n_sm, dh)
            != tk.chunk_split(1, Hkv, 64, 1, npp * ps, n_sm, dh))
    if B == 2:
        assert (tk.paged_split(B, Hkv // n, npp * ps, 1, ps, n_sm)
                != tk.paged_split(B, Hkv, npp * ps, 1, ps, n_sm))
        assert (tk.chunk_split(B, Hkv // n, 5, 1, npp * ps, n_sm, dh)
                != tk.chunk_split(B, Hkv, 5, 1, npp * ps, n_sm, dh))
    for fn, axis, qq, extras in calls:
        whole = fn(qq, kpt, vpt, *extras, k_scale=ksc, v_scale=vsc)
        for r in range(n):
            kv = slice(r * Hkv // n, (r + 1) * Hkv // n)
            qh = (slice(None),) * axis + (slice(r * H // n, (r + 1) * H // n),)
            part = fn(qq[qh].contiguous(), kpt[:, :, kv].contiguous(),
                      vpt[:, :, kv].contiguous(), *extras,
                      k_scale=None if ksc is None else ksc[kv].contiguous(),
                      v_scale=None if vsc is None else vsc[kv].contiguous(),
                      split_kv_heads=Hkv)
            assert torch.equal(part, whole[qh]), (fn.__name__, r)


@pytest.mark.cuda
def test_cuda_launch_counts_and_rejects(cuda_device):
    """Each launch counts once; a head width the kernels were not built for
    raises instead of falling back to the plain version."""
    dev = dict(device=cuda_device)
    q = torch.randn((2, 4, 64), **dev)
    kp = torch.randn((5, 16, 4, 64), **dev)
    pt = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32, **dev)
    lens = torch.tensor([20, 3], dtype=torch.int32, **dev)
    n = tk.paged_decode_attention.launches
    tk.paged_decode_attention(q, kp, kp, pt, lens)
    assert tk.paged_decode_attention.launches == n + 1
    with pytest.raises(ValueError, match="head_dim"):
        tk.paged_decode_attention(q[..., :16].contiguous(),
                                  kp[..., :16].contiguous(),
                                  kp[..., :16].contiguous(), pt, lens)
    assert tk.paged_decode_attention.launches == n + 1


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hkv,dh,L", [(4, 16, 2, 128, 545),
                                          (3, 8, 8, 64, 300),
                                          (4, *ARCTIC_WIDTH, 545),
                                          (4, *LLAVA_WIDTH, 1121),
                                          (4, *PALIGEMMA_WIDTH, 545)])
@pytest.mark.parametrize("dtype,quant", [(torch.float32, False),
                                         (torch.bfloat16, False),
                                         (torch.bfloat16, True)])
def test_cuda_dense_decode_matches_plain(cuda_device, dtype, quant, B, H,
                                         Hkv, dh, L):
    """The static engine's decode at qwen2.5-3b's width (group 8), at
    arctic-480b's (group 7), llava15-13b's (group 1, a 1,121-position
    cache), paligemma-3b's (head width 256) and a dh=64 group-1 case:
    ragged kv_valid
    from 1 to L, an L that is not a multiple of any tile, keys past
    kv_valid poisoned."""
    rng = np.random.default_rng(L)
    dev = dict(device=cuda_device)
    kc = rng.standard_normal((B, L, Hkv, dh), dtype=np.float32)
    vc = rng.standard_normal((B, L, Hkv, dh), dtype=np.float32)
    valid = rng.integers(1, L + 1, size=B).astype(np.int32)
    valid[0], valid[-1] = L, 1
    kw = {}
    if quant:
        kc, ksc = _quantize(kc)
        vc, vsc = _quantize(vc)
        kw = dict(k_scale=_t(ksc).to(**dev), v_scale=_t(vsc).to(**dev))
    kct = _t(kc).to(**dev) if quant else _t(kc).to(dtype=dtype, **dev)
    vct = _t(vc).to(**dev) if quant else _t(vc).to(dtype=dtype, **dev)
    q = _t(rng.standard_normal((B, H, dh), dtype=np.float32)).to(
        dtype=dtype, **dev)
    kv_valid = _t(valid).to(**dev)
    tol = 1e-4 if dtype == torch.float32 and not quant else 2e-2
    n = tk.decode_attention.launches
    got = tk.decode_attention(q, kct, vct, kv_valid, **kw)
    want = tk.decode_attention_plain(q, kct, vct, kv_valid, **kw)
    for b in range(B):                      # never read past kv_valid
        kct[b, valid[b]:] = 100 if quant else 1e4
        vct[b, valid[b]:] = -100 if quant else -1e4
    again = tk.decode_attention(q, kct, vct, kv_valid, **kw)
    torch.cuda.synchronize()
    assert tk.decode_attention.launches == n + 2
    assert float((got.float() - want.float()).abs().max()) <= tol
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [256, 300])
@pytest.mark.parametrize("Hkv", [2, 16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_matches_plain(cuda_device, dtype, causal, Hkv, S):
    """The static engine's prefill attention at qwen2.5-3b's width (16
    heads, group 8 and 1, head_dim 128), a prompt length that is not a
    multiple of the row tile, causal and full."""
    rng = np.random.default_rng(S + Hkv)
    dev = dict(device=cuda_device, dtype=dtype)
    B, H, dh = 2, 16, 128
    q = _t(rng.standard_normal((B, S, H, dh), dtype=np.float32)).to(**dev)
    k = _t(rng.standard_normal((B, S, Hkv, dh), dtype=np.float32)).to(**dev)
    v = _t(rng.standard_normal((B, S, Hkv, dh), dtype=np.float32)).to(**dev)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    n = tkf.flash_attention.launches
    got = tkf.flash_attention(q, k, v, causal=causal)
    want = tkf.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tkf.flash_attention.launches == n + 1
    assert float((got.float() - want.float()).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("qdt,pool", [("float32", "float32"),
                                      ("float32", "bfloat16"),
                                      ("bfloat16", "float32"),
                                      ("float16", "int8"),
                                      ("float32", "int8")])
@pytest.mark.parametrize("H,Hkv,dh", [PALIGEMMA_WIDTH, GEMMA3_WIDTH])
def test_cuda_head_width_256_takes_every_kernel(cuda_device, H, Hkv, dh,
                                                qdt, pool):
    """At head width 256 (paligemma-3b's group 8, gemma3-1b's group 4)
    every entry launches on the FMA bodies and the mixed query/pool pairs
    (f32 queries, pools of another type): the paged decode, the chunk, the
    verify window and the dense decode; flash on f32. A width none is
    built for (96) raises on the card instead of falling back."""
    rng = np.random.default_rng(25 + H)
    dev = dict(device=cuda_device)
    B, L, ps, npp, C = 3, 40, 16, 3, 8
    qt = getattr(torch, qdt)

    def rand(*shape, dtype=qt):
        return _t(rng.standard_normal(shape, dtype=np.float32)).to(
            dtype=dtype, **dev)
    q3, kp, vp, pt, kw = _paged_inputs(rng, cuda_device, B, H, Hkv, dh, ps,
                                       npp, C, pool)
    q3 = q3.to(qt)
    ptt = _t(pt).to(cuda_device)
    lens = torch.tensor([L, 7, 1], dtype=torch.int32, **dev)
    tol = 1e-4 if "float32" == qdt == pool else 2e-2
    n = [f.launches for f in (tk.paged_decode_attention,
                              tk.chunk_prefill_attention,
                              tk.spec_verify_attention, tk.decode_attention)]
    q = q3[:, 0].contiguous()
    got = [tk.paged_decode_attention(q, kp, vp, ptt, lens, **kw),
           tk.chunk_prefill_attention(q3, kp, vp, ptt, 0, lens, **kw),
           tk.spec_verify_attention(q3[:, :5].contiguous(), kp, vp, ptt,
                                    lens - 1, torch.ones_like(lens), **kw)]
    want = [tk.paged_decode_attention_plain(q, kp, vp, ptt, lens, **kw),
            tk.chunk_prefill_attention_plain(q3, kp, vp, ptt, 0, lens, **kw),
            tk.spec_verify_attention_plain(q3[:, :5].contiguous(), kp, vp,
                                           ptt, lens - 1,
                                           torch.ones_like(lens), **kw)]
    kc = kp[ptt.long()].reshape(B, npp * ps, Hkv, dh)
    vc = vp[ptt.long()].reshape(B, npp * ps, Hkv, dh)
    got.append(tk.decode_attention(q, kc, vc, lens, **kw))
    want.append(tk.decode_attention_plain(q, kc, vc, lens, **kw))
    torch.cuda.synchronize()
    assert [f.launches for f in (tk.paged_decode_attention,
                                 tk.chunk_prefill_attention,
                                 tk.spec_verify_attention,
                                 tk.decode_attention)] == [k + 1 for k in n]
    for g, w in zip(got, want):
        assert float((g.float() - w.float()).abs().max()) <= tol
    if qdt == pool == "float32":
        qf, kf = rand(B, 33, H, dh), rand(B, 33, Hkv, dh)
        for causal in (True, False):
            g = tkf.flash_attention(qf, kf, kf, causal=causal)
            w = tkf.flash_attention_plain(qf, kf, kf, causal=causal)
            assert float((g - w).abs().max()) <= 1e-4
    narrow = [x[..., :96].contiguous() for x in (q3, kp, vp)]
    with pytest.raises(ValueError, match="head_dim 96"):
        tk.chunk_prefill_attention(*narrow, ptt, 0, lens, **kw)
    with pytest.raises(ValueError, match="head_dim 96"):
        tk.paged_decode_attention(narrow[0][:, 0].contiguous(), *narrow[1:],
                                  ptt, lens, **kw)
    if pool == qdt:
        with pytest.raises(ValueError, match="head_dim 96"):
            tkf.flash_attention(narrow[0], narrow[0][:, :, :Hkv].contiguous(),
                                narrow[0][:, :, :Hkv].contiguous())


@pytest.mark.cuda
def test_cuda_paged_kernels_at_qwen_width(cuda_device):
    """The paged kernels at head_dim 128 and group 8 (qwen2.5-3b), which
    the continuous path serves at that width."""
    rng = np.random.default_rng(9)
    B, H, Hkv, dh, ps, npp, C = 4, 16, 2, 128, 16, 8, 32
    P = B * npp + 1
    dev = dict(device=cuda_device)
    kp, vp = (_t(a).to(**dev) for a in _pool(rng, P, ps, Hkv, dh))
    pt = _t(_tables(rng, B, npp, P)).to(**dev)
    lens = _t(rng.integers(1, npp * ps + 1, size=B).astype(np.int32)).to(
        **dev)
    q = _t(rng.standard_normal((B, H, dh), dtype=np.float32)).to(**dev)
    got = tk.paged_decode_attention(q, kp, vp, pt, lens)
    want = tk.paged_decode_attention_plain(q, kp, vp, pt, lens)
    assert float((got - want).abs().max()) <= 1e-4
    qc = _t(rng.standard_normal((B, C, H, dh), dtype=np.float32)).to(**dev)
    nv = torch.full((B,), 40, dtype=torch.int32, **dev)
    got = tk.chunk_prefill_attention(qc, kp, vp, pt, 8, nv)
    want = tk.chunk_prefill_attention_plain(qc, kp, vp, pt, 8, nv)
    assert float((got - want).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hkv,dh,L", [(4, 16, 2, 128, 545),
                                          (32, 64, 8, 128, 545),
                                          (7, 8, 8, 64, 300),
                                          (12, *ARCTIC_WIDTH, 545),
                                          (4, *LLAVA_WIDTH, 1121),
                                          (2, *LLAVA_WIDTH, 32256),
                                          (12, *PALIGEMMA_WIDTH, 545)])
@pytest.mark.parametrize("dtype,quant", [(torch.float32, False),
                                         (torch.bfloat16, False),
                                         (torch.float16, False),
                                         (torch.bfloat16, True)])
def test_cuda_dense_decode_split_boundaries(cuda_device, dtype, quant, B, H,
                                            Hkv, dh, L):
    """The split-K decode with kv_valid at 1, L and its splits' boundaries
    +-1: the static path's shape (many splits), B=32 with Hkv=8 (B * Hkv
    alone fills the card: only the 128-key cap splits the cache), a dh=64
    group-1 case, arctic-480b's group 7, llava15-13b's group 1 (also over
    its 32,256-position cache: 252 splits, kv_valid at L and the last
    boundary - 1) and paligemma-3b's head width 256. Keys past kv_valid
    are poisoned; two calls are bitwise equal. A row over thousands of
    keys averages them down to a few hundredths, so the long case holds
    16-bit outputs to four ulps of the largest value instead of 2e-2."""
    split = tk.decode_split(B, Hkv, L, H // Hkv,
                            tk._sm_count(torch.cuda.current_device()))
    rng = np.random.default_rng(B + L)
    dev = dict(device=cuda_device)
    kc = rng.standard_normal((B, L, Hkv, dh), dtype=np.float32)
    vc = rng.standard_normal((B, L, Hkv, dh), dtype=np.float32)
    edges = split_edges(L, split)
    long_ctx = L >= 8192
    if long_ctx:                            # the top edges: every row long
        edges = edges[::-1]
    valid = np.asarray([edges[i % len(edges)] for i in range(B)], np.int32)
    kw = {}
    if quant:
        kc, ksc = _quantize(kc)
        vc, vsc = _quantize(vc)
        kw = dict(k_scale=_t(ksc).to(**dev), v_scale=_t(vsc).to(**dev))
    kct = _t(kc).to(**dev) if quant else _t(kc).to(dtype=dtype, **dev)
    vct = _t(vc).to(**dev) if quant else _t(vc).to(dtype=dtype, **dev)
    q = _t(rng.standard_normal((B, H, dh), dtype=np.float32)).to(
        dtype=dtype, **dev)
    kv_valid = _t(valid).to(**dev)
    want = tk.decode_attention_plain(q, kct, vct, kv_valid, **kw)
    if dtype == torch.float32:
        tol = 1e-4
    elif long_ctx:
        tol = 4 * torch.finfo(dtype).eps * float(want.float().abs().max())
    else:
        tol = 2e-2
    for b in range(B):                      # never read past kv_valid
        kct[b, valid[b]:] = 100 if quant else 1e4
        vct[b, valid[b]:] = -100 if quant else -1e4
    got = tk.decode_attention(q, kct, vct, kv_valid, **kw)
    again = tk.decode_attention(q, kct, vct, kv_valid, **kw)
    torch.cuda.synchronize()
    assert float((got.float() - want.float()).abs().max()) <= tol
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 17, 64, 300])
@pytest.mark.parametrize("H,Hkv,dh", [(16, 2, 128), (8, 8, 64), (12, 4, 64),
                                      ARCTIC_WIDTH, LLAVA_WIDTH,
                                      PALIGEMMA_WIDTH, GEMMA3_WIDTH])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_cuda_flash_tensor_core_tiles_match_plain(cuda_device, dtype, causal,
                                                  H, Hkv, dh, S):
    """The tensor-core flash tiles at head widths 64, 128 and 256 (Q read
    from shared memory each key step) and groups 8, 1, 3, 7 and 4, and
    llava15-13b's 40 heads at group 1, at prompt lengths shorter than a tile, one tile, and not a multiple
    of either the 64-row or the 64-key tile; causal and full; bitwise
    repeatable."""
    rng = np.random.default_rng(S + H + dh)
    dev = dict(device=cuda_device, dtype=dtype)
    B = 2
    q = _t(rng.standard_normal((B, S, H, dh), dtype=np.float32)).to(**dev)
    k = _t(rng.standard_normal((B, S, Hkv, dh), dtype=np.float32)).to(**dev)
    v = _t(rng.standard_normal((B, S, Hkv, dh), dtype=np.float32)).to(**dev)
    got = tkf.flash_attention(q, k, v, causal=causal)
    again = tkf.flash_attention(q, k, v, causal=causal)
    want = tkf.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert float((got.float() - want.float()).abs().max()) <= 2e-2
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_cuda_paged_libraries_unchanged(cuda_device):
    """Paged decode launches from its library built anew from the split-K
    header, not from the library of its earlier row-tile body; the chunk
    launches from its library built from the tensor-core header."""
    q = torch.randn((2, 4, 64), device=cuda_device)
    kp = torch.randn((5, 16, 4, 64), device=cuda_device)
    pt = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32, device=cuda_device)
    lens = torch.tensor([20, 3], dtype=torch.int32, device=cuda_device)
    tk.paged_decode_attention(q, kp, kp, pt, lens)
    tk.chunk_prefill_attention(q[:, None], kp, kp, pt, 2, lens)
    torch.cuda.synchronize()
    path = kbuild.lib_path("paged_decode_attention")
    assert path.name != OLD_PAGED_DECODE_LIB and path.exists()
    assert set(kbuild.headers("paged_decode_attention")) == PAGED_DECODE_HEADERS
    assert kbuild.lib_path("chunk_prefill_attention").exists()
    assert set(kbuild.headers("chunk_prefill_attention")) == CHUNK_HEADERS


def _paged_inputs(rng, dev, B, H, Hkv, dh, ps, npp, C, pool):
    """Pools of B * npp + 1 pages in the pool type (f32, bf16, f16, or
    int8 with bf16 queries), disjoint shuffled tables, queries (B, C, H,
    dh). Returns (q, k, v, table (numpy), scale kwargs)."""
    P = B * npp + 1
    kp, vp = _pool(rng, P, ps, Hkv, dh)
    qdt = torch.bfloat16 if pool == "int8" else getattr(torch, pool)
    kw = {}
    if pool == "int8":
        kp, ksc = _quantize(kp)
        vp, vsc = _quantize(vp)
        kw = dict(k_scale=_t(ksc).to(dev), v_scale=_t(vsc).to(dev))
        kpt, vpt = _t(kp).to(dev), _t(vp).to(dev)
    else:
        kpt, vpt = (_t(a).to(device=dev, dtype=qdt) for a in (kp, vp))
    q = _t(rng.standard_normal((B, C, H, dh), dtype=np.float32)).to(
        device=dev, dtype=qdt)
    return q, kpt, vpt, _tables(rng, B, npp, P), kw


def _poison_past(kp, vp, pt, limits, ps, quant):
    """NaN (int8: extreme values) into every pool row that holds a key at
    or past a sequence's last frontier and no key before one: the kernel
    must never load them."""
    slots = lambda b, ks: {(int(pt[b, k // ps]), k % ps) for k in ks}
    live = set().union(*(slots(b, range(int(lim)))
                         for b, lim in enumerate(limits)))
    for b, lim in enumerate(limits):
        for page, off in slots(b, range(int(lim), pt.shape[1] * ps)) - live:
            kp[page, off] = 127 if quant else float("nan")
            vp[page, off] = -127 if quant else float("nan")


# groups 1, 4, 8 and 7; paligemma-3b's group 8 and gemma3-1b's group 4 at
# head width 256
PAGED_TC_WIDTHS = [(32, 32, 64), (8, 2, 64), (16, 2, 128), ARCTIC_WIDTH,
                   PALIGEMMA_WIDTH, GEMMA3_WIDTH]
# bf16/f16 round P to the input dtype for the tensor-core value product
# (the plain version keeps it in f32): one ulp of the output; f32 runs the
# FMA body in f32
PAGED_TC_TOL = {"float32": 1e-4, "bfloat16": 2e-2, "float16": 2e-2,
                "int8": 2e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["bfloat16", "float16", "int8", "float32"])
@pytest.mark.parametrize("H,Hkv,dh", PAGED_TC_WIDTHS)
def test_cuda_chunk_split_edges_match_plain(cuda_device, H, Hkv, dh, pool):
    """The chunk on its tensor-core tiles (bf16/f16/int8 pools; f32 on the
    FMA body) at groups 1, 4, 8 and 7 and head_dim 64, 128 and 256: the last row's
    frontier one key before, on and past a split edge, right-padded
    chunks, keys past each chunk's frontier poisoned; bitwise repeatable."""
    rng = np.random.default_rng(H + dh)
    B, ps, npp, C = 4, 16, 36, 64
    split = tk.chunk_split(B, Hkv, C, H // Hkv, npp * ps,
                           tk._sm_count(torch.cuda.current_device()), dh)
    q, kp, vp, pt, kw = _paged_inputs(rng, cuda_device, B, H, Hkv, dh, ps,
                                      npp, C, pool)
    for edge in (split, 2 * split):
        start, nv = chunk_edges(edge, C, npp * ps)
        st, nvt = _t(start).to(cuda_device), _t(nv).to(cuda_device)
        ptt = _t(pt).to(cuda_device)
        want = tk.chunk_prefill_attention_plain(q, kp, vp, ptt, st, nvt, **kw)
        kpp, vpp = kp.clone(), vp.clone()
        _poison_past(kpp, vpp, pt, np.minimum(start + C, nv), ps,
                     pool == "int8")
        n = tk.chunk_prefill_attention.launches
        got = tk.chunk_prefill_attention(q, kpp, vpp, ptt, st, nvt, **kw)
        again = tk.chunk_prefill_attention(q, kpp, vpp, ptt, st, nvt, **kw)
        torch.cuda.synchronize()
        assert tk.chunk_prefill_attention.launches == n + 2
        err = float((got.float() - want.float()).abs().max())
        assert err <= PAGED_TC_TOL[pool], (edge, err)
        assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 5, 8])
@pytest.mark.parametrize("pool", ["bfloat16", "float16", "int8", "float32"])
@pytest.mark.parametrize("H,Hkv,dh", PAGED_TC_WIDTHS)
def test_cuda_verify_split_edges_match_plain(cuda_device, H, Hkv, dh, pool,
                                             C):
    """The verify window on the tensor-core tiles (16-row tiles where C *
    group <= 16): windows crossing a split edge, fewer fed tokens than
    rows, an inactive row on a table of null pages, keys past each window
    poisoned; bitwise repeatable."""
    rng = np.random.default_rng(C + H + dh)
    B, ps, npp = 6, 16, 36
    split = tk.chunk_split(B, Hkv, C, H // Hkv, npp * ps,
                           tk._sm_count(torch.cuda.current_device()), dh)
    q, kp, vp, pt, kw = _paged_inputs(rng, cuda_device, B, H, Hkv, dh, ps,
                                      npp, C, pool)
    pt[0] = 0
    seq_lens, n_fed = _verify_window(rng, B, C, npp, ps)
    for i, d in enumerate((-C, -C // 2 - 1, -1, 0, 1)):
        seq_lens[i + 1] = max(0, split + d)
    n_fed[2] = max(1, C - 1)
    want = tk.spec_verify_attention_plain(
        q, kp, vp, _t(pt).to(cuda_device), _t(seq_lens).to(cuda_device),
        _t(n_fed).to(cuda_device), **kw)
    _poison_past(kp, vp, pt, seq_lens + n_fed, ps, pool == "int8")
    args = (q, kp, vp, _t(pt).to(cuda_device), _t(seq_lens).to(cuda_device),
            _t(n_fed).to(cuda_device))
    got = tk.spec_verify_attention(*args, **kw)
    again = tk.spec_verify_attention(*args, **kw)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    assert err <= PAGED_TC_TOL[pool], err
    assert torch.equal(got, again)


def _stale_tails(pt, seq_lens, ps, n_pages):
    """Table entries wholly past each sequence's length keep their (now
    stale) pages, except every third, which gets an id outside the pool
    (read as the null page 0 if it were read)."""
    pt = pt.copy()
    for b, n in enumerate(seq_lens):
        for i in range(-(-int(n) // ps), pt.shape[1]):
            if i % 3 == 0:
                pt[b, i] = n_pages + i if i % 2 else -1 - i
    return pt


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["bfloat16", "float16", "int8", "float32"])
@pytest.mark.parametrize("H,Hkv,dh", PAGED_TC_WIDTHS)
def test_cuda_paged_decode_split_edges_match_plain(cuda_device, H, Hkv, dh,
                                                   pool):
    """The paged decode split over pages, at groups 1, 4, 8 and 7 and head_dim
    64, 128 and 256: seq_lens at 1, the full table and every split edge +-1
    (B=16 sequences a call, the edges over as many calls as they need);
    stale table entries and the keys past each sequence poisoned (NaN;
    int8: extreme values); bitwise repeatable; one launch counted a call."""
    rng = np.random.default_rng(H + dh + len(pool))
    B, ps, npp = 16, 16, 36
    n_keys = npp * ps
    split = tk.paged_split(B, Hkv, n_keys, H // Hkv, ps,
                           tk._sm_count(torch.cuda.current_device()))
    assert split % ps == 0
    edges = split_edges(n_keys, split)
    q3, kp, vp, pt, kw = _paged_inputs(rng, cuda_device, B, H, Hkv, dh, ps,
                                       npp, 1, pool)
    q = q3[:, 0].contiguous()
    for i in range(0, len(edges), B):
        lens = np.asarray([edges[i:][j % len(edges[i:])] for j in range(B)],
                          np.int32)
        ptt = _t(pt).to(cuda_device)
        lt = _t(lens).to(cuda_device)
        want = tk.paged_decode_attention_plain(q, kp, vp, ptt, lt, **kw)
        kpp, vpp = kp.clone(), vp.clone()
        _poison_past(kpp, vpp, pt, lens, ps, pool == "int8")
        stale = _t(_stale_tails(pt, lens, ps, kp.shape[0])).to(cuda_device)
        n = tk.paged_decode_attention.launches
        got = tk.paged_decode_attention(q, kpp, vpp, stale, lt, **kw)
        again = tk.paged_decode_attention(q, kpp, vpp, stale, lt, **kw)
        torch.cuda.synchronize()
        assert tk.paged_decode_attention.launches == n + 2
        err = float((got.float() - want.float()).abs().max())
        assert err <= PAGED_TC_TOL[pool], (lens.tolist(), err)
        assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("ps", [1, 5, 64, 256])
@pytest.mark.parametrize("pool", ["bfloat16", "int8"])
def test_cuda_paged_decode_page_sizes(cuda_device, pool, ps):
    """Page sizes from one key to a 256-key page (a split is a whole number
    of pages, so a large page is a split of its own), a group of 2 and
    ragged lengths with one sequence at the full table."""
    rng = np.random.default_rng(ps)
    B, H, Hkv, dh = 3, 8, 4, 64
    npp = -(-300 // ps)
    q3, kp, vp, pt, kw = _paged_inputs(rng, cuda_device, B, H, Hkv, dh, ps,
                                       npp, 1, pool)
    q = q3[:, 0].contiguous()
    lens = rng.integers(1, npp * ps + 1, size=B).astype(np.int32)
    lens[0] = npp * ps
    ptt, lt = _t(pt).to(cuda_device), _t(lens).to(cuda_device)
    want = tk.paged_decode_attention_plain(q, kp, vp, ptt, lt, **kw)
    got = tk.paged_decode_attention(q, kp, vp, ptt, lt, **kw)
    torch.cuda.synchronize()
    assert float((got.float() - want.float()).abs().max()) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("T", [8, 64])
def test_cuda_moe_ffn_has_no_host_sync(cuda_device, T):
    """The capacity dispatch of the MoE FFN (reduced arctic-480b, f32)
    reads nothing back to the host at a decode step's and a prefill
    chunk's token count, and agrees with the CPU."""
    cfg = reduced(get_config("arctic-480b"), d_model=64)
    params = init_params(cfg, torch.Generator().manual_seed(0), "float32",
                         "cpu")
    p = _layer0(params["stack"]["moe"])
    x = torch.randn((1, T, 64), generator=torch.Generator().manual_seed(T))
    want, _ = tmoe.moe_ffn(p, x, cfg)
    pc, xc = _to(p, cuda_device), x.to(cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, aux = tmoe.moe_ffn(pc, xc, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert float((got.cpu() - want).abs().max()) <= 1e-4
    assert all(bool(torch.isfinite(v)) for v in aux.values())


def _layer0(tree):
    if isinstance(tree, dict):
        return {k: _layer0(v) for k, v in tree.items()}
    return tree[0]


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("scheduler", ["continuous", "static"])
def test_cuda_engine_refuses_a_width_before_drawing_weights(
        cuda_device, monkeypatch, scheduler):
    """A reduced twin (head width 16) on the card is refused at
    construction with NotImplementedError, before any weights are drawn
    and before any kernel is built or launched; gemma3-1b's twin, whose
    layers reach no kernel, is not."""
    import repro_torch.serving.engine as teng
    from repro_torch.serving import ServeEngine

    def boom(*a, **k):
        raise AssertionError("init_params was called")
    monkeypatch.setattr(teng, "init_params", boom)
    launches = [e.launches for e in (tk.paged_decode_attention,
                                     tk.chunk_prefill_attention,
                                     tk.decode_attention,
                                     tkf.flash_attention)]
    with pytest.raises(NotImplementedError, match="head_dim 16"):
        ServeEngine(reduced(get_config("llama3.2-1b")), device="cuda",
                    scheduler=scheduler)
    assert launches == [e.launches for e in (tk.paged_decode_attention,
                                             tk.chunk_prefill_attention,
                                             tk.decode_attention,
                                             tkf.flash_attention)]
    with pytest.raises(AssertionError, match="init_params was called"):
        ServeEngine(reduced(get_config("gemma3-1b")), device="cuda",
                    scheduler="static")


@pytest.mark.cuda
def test_cuda_flash_refuses_autograd(cuda_device):
    """The flash kernel has no backward: on a CUDA tensor that requires
    grad (grad mode on) it raises instead of returning an output with no
    graph; under no_grad it launches."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q = torch.randn((1, 64, 4, 64), generator=g, device=cuda_device)
    k = torch.randn((1, 64, 4, 64), generator=g, device=cuda_device)
    v = torch.randn((1, 64, 4, 64), generator=g, device=cuda_device)
    for need in (q, k, v):
        need.requires_grad_(True)
        with pytest.raises(RuntimeError, match="no backward"):
            tkf.flash_attention(q, k, v)
        with torch.no_grad():
            out = tkf.flash_attention(q, k, v)
        assert not out.requires_grad
        need.requires_grad_(False)
    n = tkf.flash_attention.launches
    tkf.flash_attention(q, k, v)
    assert tkf.flash_attention.launches == n + 1


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3.2-1b", "arctic-480b"])
def test_cuda_train_loss_matches_cpu(cuda_device, arch):
    """The reduced twin trains on the card (no width refusal: training
    reaches no kernel) and its loss and gradients match the CPU's in f32
    with TF32 off; no kernel entry launches."""
    import repro_torch.models as tm
    from repro_torch.data import for_arch
    from repro_torch.tree import leaves, tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(get_config(arch))
    params = tm.init_params(cfg, torch.Generator().manual_seed(0),
                            "float32", "cpu")
    batch = for_arch(cfg, 32, 2, seed=0).batch_at(0)
    opts = tm.RuntimeOptions(dtype="float32")

    def run(p, b):
        p = tree_map(lambda t: t.detach().requires_grad_(), p)
        loss, _ = tm.train_loss(cfg, p, b, opts)
        return loss.detach(), torch.autograd.grad(loss, leaves(p))
    l0, g0 = run(params, batch)
    entries = (tk.paged_decode_attention, tk.chunk_prefill_attention,
               tk.spec_verify_attention, tk.decode_attention,
               tkf.flash_attention)
    before = [e.launches for e in entries]
    l1, g1 = run(tree_map(lambda t: t.to(cuda_device), params),
                 {k: v.to(cuda_device) for k, v in batch.items()})
    assert [e.launches for e in entries] == before
    assert abs(float(l1) - float(l0)) <= 1e-5 * abs(float(l0))
    for a, b in zip(g1, g0):
        assert float((a.cpu() - b).abs().max()) <= (
            1e-4 * float(b.abs().max()) + 1e-6)


# ------------------------ head widths 384 and 512 ------------------------ #

# groups 8 and 4 over one KV head at 384 and 512 (the dh-512 text decoder
# serves group 4 at 512)
WIDE_WIDTHS = [(8, 1, 384), (4, 1, 384), (8, 1, 512), (4, 1, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["bfloat16", "float16", "int8", "float32"])
@pytest.mark.parametrize("H,Hkv,dh", WIDE_WIDTHS)
def test_cuda_wide_chunk_split_edges_match_plain(cuda_device, H, Hkv, dh,
                                                 pool):
    """The chunk kernel's split edges at 384 and 512: two warps share each
    16-row tile's columns, 32 keys a stage (``chunk_split`` takes dh)."""
    test_cuda_chunk_split_edges_match_plain(cuda_device, H, Hkv, dh, pool)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 5, 8])
@pytest.mark.parametrize("pool", ["bfloat16", "int8", "float32"])
@pytest.mark.parametrize("H,Hkv,dh", WIDE_WIDTHS)
def test_cuda_wide_verify_split_edges_match_plain(cuda_device, H, Hkv, dh,
                                                  pool, C):
    test_cuda_verify_split_edges_match_plain(cuda_device, H, Hkv, dh, pool,
                                             C)


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["bfloat16", "float16", "int8", "float32"])
@pytest.mark.parametrize("H,Hkv,dh", WIDE_WIDTHS)
def test_cuda_wide_paged_decode_split_edges_match_plain(cuda_device, H, Hkv,
                                                        dh, pool):
    """The paged decode's lane geometry at 384 (a row of 3 x 2^k loads:
    16, 32 or 8 lanes of three) and 512 (every type over 32 lanes)."""
    test_cuda_paged_decode_split_edges_match_plain(cuda_device, H, Hkv, dh,
                                                   pool)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,quant", [(torch.float32, False),
                                         (torch.bfloat16, False),
                                         (torch.float16, False),
                                         (torch.bfloat16, True)])
@pytest.mark.parametrize("H,Hkv,dh", WIDE_WIDTHS)
def test_cuda_wide_dense_decode_split_boundaries(cuda_device, dtype, quant,
                                                 H, Hkv, dh):
    """The dense decode's split pass at 384 (10-key tiles, 8 rows a block)
    and 512 (8-key tiles, 4 rows) on its split edges."""
    test_cuda_dense_decode_split_boundaries(cuda_device, dtype, quant, 12, H,
                                            Hkv, dh, 545)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 17, 64, 300])
@pytest.mark.parametrize("H,Hkv,dh", WIDE_WIDTHS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_cuda_wide_flash_tensor_core_tiles_match_plain(cuda_device, dtype,
                                                       causal, H, Hkv, dh, S):
    """Flash's tensor-core tiles at 384 and 512: 8 warps a 64-row tile, two
    on each 16 rows, each holding half of O's columns."""
    test_cuda_flash_tensor_core_tiles_match_plain(cuda_device, dtype, causal,
                                                  H, Hkv, dh, S)


@pytest.mark.cuda
@pytest.mark.parametrize("qdt,pool", [("float32", "float32"),
                                      ("float32", "bfloat16"),
                                      ("bfloat16", "float32"),
                                      ("float16", "int8"),
                                      ("float32", "int8")])
@pytest.mark.parametrize("H,Hkv,dh", WIDE_WIDTHS)
def test_cuda_wide_heads_take_every_kernel(cuda_device, H, Hkv, dh, qdt,
                                           pool):
    """The FMA bodies and mixed query/pool pairs at 384 and 512, as at 256;
    the narrower width 96 still raises."""
    test_cuda_head_width_256_takes_every_kernel(cuda_device, H, Hkv, dh, qdt,
                                                pool)


@pytest.mark.cuda
def test_cuda_width_640_is_refused(cuda_device):
    """Above 512 no kernel is built (ROADMAP B8): every entry raises on the
    card rather than falling back to its plain version."""
    dev = dict(device=cuda_device, dtype=torch.bfloat16)
    q = torch.zeros((2, 4, 640), **dev)
    kp = torch.zeros((5, 16, 1, 640), **dev)
    pt = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32,
                      device=cuda_device)
    lens = torch.tensor([20, 3], dtype=torch.int32, device=cuda_device)
    calls = [lambda: tk.paged_decode_attention(q, kp, kp, pt, lens),
             lambda: tk.chunk_prefill_attention(q[:, None], kp, kp, pt, 2,
                                                lens),
             lambda: tk.spec_verify_attention(q[:, None], kp, kp, pt, lens,
                                              torch.ones_like(lens)),
             lambda: tk.decode_attention(q, kp[:2], kp[:2], lens),
             lambda: tkf.flash_attention(q[:, None], kp[:2, :1],
                                         kp[:2, :1])]
    for call in calls:
        with pytest.raises(ValueError, match="head_dim 640"):
            call()
