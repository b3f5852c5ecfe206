"""The split-K algebra of the port's dense decode kernel
(csrc/decode_attention.cu over csrc/split_decode.cuh), on the CPU.

``_decode_split_plain`` mirrors the kernel's two passes (per-split partial
max, sum and unnormalised accumulator; a fixed-order combine). Here it is
held against the JAX ``decode_attention`` Pallas kernel in interpret mode
and against the port's plain version, on inputs made with numpy from a
seed (f32 and int8 caches), at split sizes 1, 7, 64 and at least L, with
``kv_valid`` at 1, L and every split boundary +-1. The split-size function
is checked for covering L from the shapes alone. The CUDA kernel itself is
held against the plain version on the card by
tests/test_torch_kernels_cuda.py and chip_smoke.py."""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.decode_attention as da
import repro_torch.kernels.decode_attention as tk
from repro_torch.kernels import build as kbuild
from torch_kernel_inputs import CHUNK_HEADERS
from torch_kernel_inputs import OLD_CHUNK_LIB
from torch_kernel_inputs import OLD_PAGED_DECODE_LIB
from torch_kernel_inputs import PAGED_DECODE_HEADERS
from torch_kernel_inputs import quantize as _quantize
from torch_kernel_inputs import split_edges
from torch_kernel_inputs import t as _t

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)
L = 40


def _inputs(split: int, quant: bool, H=8, Hkv=2, dh=64):
    rng = np.random.default_rng(split)
    valid = np.asarray(split_edges(L, split), np.int32)
    B = len(valid)
    q = rng.standard_normal((B, H, dh), dtype=np.float32)
    kc = rng.standard_normal((B, L, Hkv, dh), dtype=np.float32)
    vc = rng.standard_normal((B, L, Hkv, dh), dtype=np.float32)
    sc = {}
    if quant:
        kc, ksc = _quantize(kc)
        vc, vsc = _quantize(vc)
        sc = dict(k_scale=ksc, v_scale=vsc)
    return q, kc, vc, valid, sc


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("split", [1, 7, 64, L, L + 9])
def test_split_plain_matches_pallas_and_plain(split, quant):
    q, kc, vc, valid, sc = _inputs(split, quant)
    want = da.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                               jnp.asarray(valid), interpret=True,
                               **{k: jnp.asarray(v) for k, v in sc.items()})
    kw = {k: _t(v) for k, v in sc.items()}
    got, _ = tk._decode_split_plain(_t(q), _t(kc), _t(vc), _t(valid), split,
                                    **kw)
    plain = tk.decode_attention_plain(_t(q), _t(kc), _t(vc), _t(valid), **kw)
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("split", [1, 7, 64])
def test_splits_past_kv_valid_contribute_exactly_zero(split, quant):
    """A split wholly past kv_valid has m = NEG_INF, l = 0, acc = 0, and
    keys past kv_valid do not reach the output: poisoning them leaves it
    bitwise unchanged."""
    q, kc, vc, valid, sc = _inputs(split, quant)
    kw = {k: _t(v) for k, v in sc.items()}
    out, (m, l, acc) = tk._decode_split_plain(_t(q), _t(kc), _t(vc),
                                              _t(valid), split, **kw)
    n_split = m.shape[-1]
    assert n_split == -(-L // split)
    past = (torch.arange(n_split)[None, :] * split
            >= _t(valid)[:, None].long())                   # (B, n_split)
    past = past[:, None, :].expand_as(m)
    assert bool((m[past] == tk.NEG_INF).all())
    assert bool((l[past] == 0).all()) and bool((acc[past] == 0).all())
    assert bool((l[~past] > 0).all())
    for b, n in enumerate(valid):
        kc[b, n:] = 100 if quant else 1e4
        vc[b, n:] = -100 if quant else -1e4
    poisoned, _ = tk._decode_split_plain(_t(q), _t(kc), _t(vc), _t(valid),
                                         split, **kw)
    assert torch.equal(out, poisoned)


SHAPES = [(4, 2, 545, 8), (32, 8, 545, 8), (1, 1, 1, 1), (8, 32, 576, 1),
          (2, 1, 17, 64), (64, 8, 4096, 4), (3, 4, 300, 2), (16, 2, 640, 8),
          (4, 8, 545, 7)]                           # arctic-480b: group 7


@pytest.mark.parametrize("B,Hkv,Lc,group", SHAPES)
@pytest.mark.parametrize("n_sm", [132, 114])
def test_decode_split_covers_the_cache(B, Hkv, Lc, group, n_sm):
    """At least one split; the splits cover L with no empty trailing
    split; 16-key multiples of at most 128 keys; about two blocks an SM
    where L allows, and no more splits than that or the 128-key cap
    needs."""
    split = tk.decode_split(B, Hkv, Lc, group, n_sm)
    n = -(-Lc // split)
    assert 16 <= split <= 128 and split % 16 == 0
    assert n >= 1 and n * split >= Lc and (n - 1) * split < Lc
    units = B * Hkv * -(-group // 16)
    assert n <= max(1, round(2 * n_sm / units) + 1, -(-Lc // 128))
    if Lc >= 16 * max(1, round(2 * n_sm / units)):
        assert units * n >= n_sm


def test_decode_split_is_a_function_of_the_shapes():
    """The split size reads shapes and the SM count only (no kv_valid, so
    no device-to-host sync); the static path's decode gets at least 132
    blocks; a batch that fills the card alone is split only as far as the
    128-key cap needs."""
    assert list(inspect.signature(tk.decode_split).parameters) == [
        "B", "Hkv", "L", "group", "n_sm", "dh"]
    split = tk.decode_split(4, 2, 545, 8, 132)
    assert split == tk.decode_split(4, 2, 545, 8, 132) == 32
    assert -(-545 // split) * 4 * 2 >= 132
    assert tk.decode_split(32, 8, 545, 8, 132) == 112
    assert tk.decode_split(32, 8, 100, 8, 132) == 112


@pytest.mark.parametrize("name", ["chunk_prefill_attention",
                                  "paged_decode_attention"])
def test_paged_libraries_unchanged(name):
    """Both paged libraries are built anew from their redesigned sources:
    the paged decode from the split-K header whose combine it shares with
    the dense decode (no tensor-core header: it runs no mma), the chunk
    from the tensor-core header it shares with flash and the split-K
    header."""
    if name == "paged_decode_attention":
        assert set(kbuild.headers(name)) == PAGED_DECODE_HEADERS
        assert kbuild.lib_path(name).name != OLD_PAGED_DECODE_LIB
    else:
        assert set(kbuild.headers(name)) == CHUNK_HEADERS
        assert kbuild.lib_path(name).name != OLD_CHUNK_LIB
        assert "mma_tile.cuh" in kbuild.headers("flash_attention")
