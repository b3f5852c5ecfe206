"""The port's on-device token choice (repro_torch.models.sampling) against
the reference's (repro.models.sampling), on the CPU.

The reference draws from JAX's threefry keys, which PyTorch cannot
reproduce; the port takes its noise as tensors. So the tests draw JAX's
own Gumbel noise and uniforms from the reference's keys, hand them to the
port, and demand the reference's tokens and acceptance counts. The port's
own counter-based draws are checked against a numpy rendering of their
formula, for determinism and batch independence, and the sampler's
frequencies against the filtered softmax."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import sampling as jsam
from repro_torch.models import sampling as tsam

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _tied_logits(seed, B, V):
    """Seeded logits on a coarse grid, so many values tie exactly."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-6, 7, size=(B, V)) / 2.0).astype(np.float32)


def _gumbel(keys, V):
    """The noise of ``jax.random.categorical(key, lg)`` on a (V,) row."""
    return np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (V,)))(keys))


# ------------------------------- filters -------------------------------- #

@pytest.mark.parametrize("temperature,top_k,top_p", [
    (0.7, 5, 1.0),        # top-k only; ties at the k-th value are kept
    (1.0, 0, 0.9),        # top-p only; equal probabilities rank by id
    (1.3, 0, 0.3),
    (0.9, 12, 0.8),       # both
])
def test_filtered_logits_match_reference(temperature, top_k, top_p):
    lg = _tied_logits(0, 16, 40)
    want = np.asarray(jsam.filtered_logits(
        jnp.asarray(lg), temperature=temperature, top_k=top_k, top_p=top_p))
    got = tsam.filtered_logits(_t(lg), temperature=temperature, top_k=top_k,
                               top_p=top_p).numpy()
    np.testing.assert_array_equal(got <= tsam.NEG_INF / 2,
                                  want <= jsam.NEG_INF / 2)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_filtered_logits_rejects_nonpositive_temperature():
    with pytest.raises(ValueError):
        tsam.filtered_logits(torch.zeros((1, 4)), temperature=0.0)


# ------------------------ decisions on JAX's noise ----------------------- #

@pytest.mark.parametrize("temperature,top_k,top_p", [
    (0.0, 0, 1.0), (1.0, 0, 1.0), (0.8, 10, 0.9)])
def test_sample_on_reference_noise(temperature, top_k, top_p):
    B, V = 32, 50
    lg = np.random.default_rng(1).normal(size=(B, V)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    want = np.asarray(jsam.sample(jnp.asarray(lg), keys,
                                  temperature=temperature, top_k=top_k,
                                  top_p=top_p))
    got = tsam.sample(_t(lg), _t(_gumbel(keys, V)), temperature=temperature,
                      top_k=top_k, top_p=top_p)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (0.0, 0, 1.0), (1.0, 0, 1.0), (0.7, 8, 0.95)])
@pytest.mark.parametrize("C", [1, 2, 5])
def test_spec_accept_on_reference_noise(temperature, top_k, top_p, C):
    """Given the reference's uniforms and Gumbel noise (split from the
    same per-slot keys as its ``spec_accept`` splits them), the port
    accepts the same drafts and emits the same tokens."""
    B, V, K = 64, 24, C - 1
    rng = np.random.default_rng(C)
    lg = (rng.normal(size=(B, C, V)) * 1.5).astype(np.float32)
    # drafts: mostly each row's argmax, some random, ragged lengths
    draft = np.argmax(lg[:, :K], axis=-1).astype(np.int32)
    flip = rng.random(size=draft.shape) < 0.3
    draft[flip] = rng.integers(0, V, size=int(flip.sum()))
    dlen = rng.integers(0, K + 1, size=B).astype(np.int32)
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    w_out, w_nacc, _ = jsam.spec_accept(
        jnp.asarray(lg), jnp.asarray(draft), jnp.asarray(dlen), keys,
        temperature=temperature, top_k=top_k, top_p=top_p, pad_id=0)
    sub = jsam.split_keys(keys, 3)
    u = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (K,)))(sub[:, 0]))
    g = _gumbel(sub[:, 1], V)
    out, n_acc = tsam.spec_accept(_t(lg), _t(draft), _t(dlen), _t(u), _t(g),
                                  temperature=temperature, top_k=top_k,
                                  top_p=top_p, pad_id=0)
    np.testing.assert_array_equal(n_acc.numpy(), np.asarray(w_nacc))
    np.testing.assert_array_equal(out.numpy(), np.asarray(w_out))
    if temperature > 0 and K:
        assert 0 < int(n_acc.sum()) < int(dlen.sum())   # both outcomes seen


# ------------------------------ the draws ------------------------------- #

M32 = 0xFFFFFFFF


def _np_mix(x):
    x = (((x >> 16) ^ x) * 0x45D9F3B) & M32
    x = (((x >> 16) ^ x) * 0x45D9F3B) & M32
    return (x >> 16) ^ x


def _np_fold(h, x):
    return _np_mix((((h ^ (x & M32)) + 0x9E3779B9)) & M32)


def _np_uniforms(seed, rid, t, draws):
    """The formula of ``sampling.uniforms``, in numpy uint64."""
    u64 = np.uint64
    h = _np_fold(u64(_np_mix(seed & M32)), u64(rid))
    h = _np_fold(h, u64(t))
    bits = _np_mix(_np_fold(h, np.asarray(draws, np.uint64)))
    return ((bits >> u64(9)).astype(np.float32) + np.float32(0.5)) \
        * np.float32(2.0 ** -23)


def test_draws_follow_their_formula():
    rids = np.asarray([0, 5, 123456, 2 ** 31 + 7])
    t = np.asarray([0, 3, 3, 1000])
    keys = tsam.request_keys(11, _t(rids), _t(t))
    draws = np.concatenate([np.arange(64), tsam.ACCEPT_DRAW + np.arange(4)])
    got = tsam.uniforms(keys, _t(draws)).numpy()
    for b in range(len(rids)):
        np.testing.assert_array_equal(
            got[b], _np_uniforms(11, int(rids[b]), int(t[b]), draws))
    assert (got > 0).all() and (got < 1).all()
    # the uniforms are exact; the logs may differ from numpy's in the last
    # f32 place
    np.testing.assert_allclose(tsam.gumbel(keys, 64).numpy(),
                               -np.log(-np.log(got[:, :64])), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(tsam.accept_uniforms(keys, 4).numpy(),
                                  got[:, 64:])


def test_draws_depend_only_on_request_and_index():
    """The same (seed, rid, token index) gives the same draws in any batch
    position and batch; another seed, rid or index gives others."""
    a = tsam.gumbel(tsam.request_keys(3, _t([4, 9, 2]), _t([7, 0, 1])), 30)
    b = tsam.gumbel(tsam.request_keys(3, _t([2, 8, 4, 4]),
                                      _t([1, 5, 7, 8])), 30)
    assert torch.equal(a[0], b[2]) and torch.equal(a[2], b[0])
    assert not torch.equal(b[2], b[3])                   # next token index
    c = tsam.gumbel(tsam.request_keys(4, _t([4]), _t([7])), 30)
    assert not torch.equal(a[0], c[0])                   # another seed
    k = tsam.request_keys(3, _t([4]), _t([5]))
    assert torch.equal(tsam.gumbel(tsam.advance(k, 2), 30)[0], a[0])


def test_draws_are_uniform():
    keys = tsam.request_keys(0, torch.arange(256), torch.zeros(256))
    u = tsam.uniforms(keys, torch.arange(512)).numpy().ravel()
    hist = np.bincount((u * 16).astype(int), minlength=16) / u.size
    assert np.abs(hist - 1 / 16).max() < 0.003         # 131k draws
    assert abs(u.mean() - 0.5) < 0.003


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (0.9, 0, 1.0), (1.2, 4, 1.0), (0.8, 0, 0.8)])
def test_sample_frequencies_match_filtered_softmax(temperature, top_k,
                                                   top_p):
    """Over many tokens of the port's own draws, the empirical frequency of
    each token tracks softmax(filtered logits) (total-variation distance
    < 0.03 at 20k draws)."""
    V, N = 8, 20000
    row = np.asarray([1.2, 0.3, -0.4, 2.0, 0.0, -1.0, 0.9, 0.1], np.float32)
    lg = _t(np.tile(row, (N, 1)))
    keys = tsam.request_keys(5, torch.arange(N) % 97, torch.arange(N) // 97)
    got = tsam.sample(lg, tsam.gumbel(keys, V), temperature=temperature,
                      top_k=top_k, top_p=top_p).numpy()
    emp = np.bincount(got, minlength=V) / N
    want = torch.softmax(tsam.filtered_logits(
        _t(row[None]), temperature=temperature, top_k=top_k,
        top_p=top_p), dim=-1)[0].numpy()
    assert 0.5 * np.abs(emp - want).sum() < 0.03
    assert (emp[want == 0] == 0).all()


def test_spec_accept_frequencies_match_target():
    """Leftover/rejection sampling on the port's draws is unbiased: the
    first emitted token follows softmax(logits / T) for a likely and an
    unlikely one-hot draft, and acceptance tracks p(draft)."""
    V, N = 6, 12000
    row = np.asarray([1.2, 0.3, -0.4, 2.0, 0.0, -1.0], np.float32)
    lg = _t(np.tile(row, (N, 2, 1)))
    want = torch.softmax(_t(row) / 0.9, dim=-1).numpy()
    keys = tsam.request_keys(1, torch.arange(N), torch.zeros(N))
    for d in (3, 1):
        out, n_acc = tsam.spec_accept(
            lg, torch.full((N, 1), d, dtype=torch.int32),
            torch.ones(N, dtype=torch.int32), tsam.accept_uniforms(keys, 1),
            tsam.gumbel(keys, V), temperature=0.9)
        emp = np.bincount(out[:, 0].numpy(), minlength=V) / N
        assert 0.5 * np.abs(emp - want).sum() < 0.03
        assert abs(float(n_acc.float().mean()) - want[d]) < 0.03
