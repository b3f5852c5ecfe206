"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Needs an NVIDIA GPU and nvcc (the kernels have no CPU mode), so every
test here is marked ``cuda`` and skips without a card; the file imports no
JAX, so it runs on a machine that has none:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

import repro_torch.kernels.decode_attention as tk
from torch_kernel_inputs import pool as _pool
from torch_kernel_inputs import quantize as _quantize
from torch_kernel_inputs import t as _t
from torch_kernel_inputs import tables as _tables

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
