"""The port's general masked attention (``repro_torch.models.common
.attention``) against the reference's XLA path
(``repro.models.common.attention``), on the CPU.

The same numpy inputs from a seed go through both, in f32 within 1e-5
(bf16 within 2e-2): every mask kind (causal, sliding, prefix, full), with
and without soft-capping, with a query offset and a valid length, in the
single-block branch (``S * L <= 1 << 21``: a softmax over the masked
scores, so a fully masked row gets the mean of V) and in the blocked
online softmax (``S * L > 1 << 21``: a fully masked row gives 0). The
masks themselves are held against the reference's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as jcm
from repro_torch.models import common as tcm
from torch_kernel_inputs import t as _t

torch.set_num_threads(2)

TOL = {np.float32: 1e-5, "bfloat16": 2e-2}
KINDS = ("causal", "sliding", "prefix", "full")


def _inputs(seed, B, S, L, H, Hkv, dh, dtype=np.float32):
    """Seeded q (B, S, H, dh), k and v (B, L, Hkv, dh) for both packages."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((B, S, H, dh), (B, L, Hkv, dh), (B, L, Hkv, dh))]
    if dtype == "bfloat16":
        ts = [_t(a).to(torch.bfloat16) for a in arrs]
        return ([jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
                 for x in ts], ts)
    return [jnp.asarray(a) for a in arrs], [_t(a) for a in arrs]


def _both(js, ts, kv_valid=None, **kw):
    want = jcm.attention(*js, kv_valid=(None if kv_valid is None
                                        else jnp.asarray(kv_valid)), **kw)
    got = tcm.attention(*ts, kv_valid=(None if kv_valid is None
                                       else _t(kv_valid)), **kw)
    return got, want


def _close(got, want, tol):
    assert got.shape == tuple(want.shape)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, dtype=np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_single_block_matches_reference(kind, offset, softcap):
    """S * L <= 1 << 21. With ``offset``: queries at positions 5..11 of a
    12-key cache and kv_valid (12, 9), as a decode over a dense cache
    sees them."""
    B, S, L, H, Hkv, dh = 2, 7, 12, 4, 2, 16
    js, ts = _inputs(7, B, S, L, H, Hkv, dh)
    kw = dict(mask_kind=kind, window=4, prefix_len=3, softcap=softcap)
    valid = None
    if offset:
        kw["q_offset"] = 5
        valid = np.asarray([12, 9], np.int32)
    got, want = _both(js, ts, valid, **kw)
    _close(got, want, TOL[np.float32])
    assert got.dtype == torch.float32


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("kind", KINDS)
def test_blocked_branch_matches_reference(kind, softcap):
    """S * L = 520 * 4100 > 1 << 21: the blocked online softmax over
    (512, 1024) tiles, both padded at the edge; queries at an offset of
    3000, kv_valid 4000 of 4100 keys."""
    B, S, L, H, Hkv, dh = 1, 520, 4100, 2, 1, 16
    assert S * L > 1 << 21
    js, ts = _inputs(11, B, S, L, H, Hkv, dh)
    got, want = _both(js, ts, np.asarray([4000], np.int32),
                      mask_kind=kind, window=700, prefix_len=3100,
                      q_offset=3000, softcap=softcap)
    _close(got, want, TOL[np.float32])


def test_blocked_branch_prompt_without_offset():
    """The blocked branch as a long prompt's prefill sees it: S = L =
    1500, no offset, no valid length, a 512-key window."""
    js, ts = _inputs(12, 2, 1500, 1500, 4, 1, 16)
    got, want = _both(js, ts, mask_kind="sliding", window=512, softcap=30.0)
    _close(got, want, TOL[np.float32])


@pytest.mark.parametrize("S,L", [(5, 9), (520, 4100)])
def test_fully_masked_rows_follow_each_branch(S, L):
    """A sequence with kv_valid 0 masks every key: the single-block
    softmax gives the mean of V, the blocked online softmax gives 0; both
    as the reference does."""
    js, ts = _inputs(13, 2, S, L, 2, 2, 16)
    got, want = _both(js, ts, np.asarray([L, 0], np.int32),
                      mask_kind="causal", q_offset=L - S)
    _close(got, want, TOL[np.float32])
    row = got[1].float()
    if S * L <= 1 << 21:
        mean_v = ts[2][1].mean(dim=0)                      # (Hkv, dh)
        torch.testing.assert_close(row[0].reshape(2, 16), mean_v,
                                   atol=1e-5, rtol=1e-5)
    else:
        assert float(row.abs().max()) == 0.0


@pytest.mark.parametrize("kind", ["prefix", "sliding"])
def test_bfloat16_rounds_p_to_v_dtype(kind):
    """bf16 operands: p is rounded to V's dtype before the value product
    on both sides."""
    js, ts = _inputs(14, 2, 16, 16, 8, 1, 32, "bfloat16")
    got, want = _both(js, ts, mask_kind=kind, window=5, prefix_len=6,
                      softcap=30.0)
    assert got.dtype == torch.bfloat16
    _close(got, want, TOL["bfloat16"])


@pytest.mark.parametrize("name,args", [
    ("causal_mask", (6, 9, 3)),
    ("sliding_mask", (6, 9, 4, 3)),
    ("prefix_lm_mask", (6, 9, 4, 2)),
])
def test_masks_match_reference(name, args):
    want = np.asarray(getattr(jcm, name)(*args))
    got = getattr(tcm, name)(*args)
    np.testing.assert_array_equal(got.numpy(), want)


def test_length_mask_matches_reference():
    valid = np.asarray([[3], [7]], np.int32)
    np.testing.assert_array_equal(
        tcm.length_mask(9, _t(valid)).numpy(),
        np.asarray(jcm.length_mask(9, jnp.asarray(valid))))


def test_counts_its_calls():
    q = torch.zeros((1, 2, 2, 8))
    n = tcm.attention.calls
    tcm.attention(q, q, q)
    tcm.attention(q, q, q, mask_kind="full")
    assert tcm.attention.calls == n + 2
