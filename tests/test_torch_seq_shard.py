"""Sequence-sharded decode attention of the port
(``models.seq_shard_attn``) on real ranks: N = 1, 2, 4 gloo ranks spawned
on the CPU, each holding a contiguous length slice of the cache, against
the reference's ``decode_attn_seq_sharded`` under ``shard_map`` on a
(1, N) Auto-axis mesh of host devices (a subprocess:
``torch_ref_mesh.py``). f32; outputs within 1e-5, each rank's cache
slice bitwise the reference's after the write. Then a reduced gemma3-1b
(6 layers: five sliding-window layers, one global, soft-capped) decoded
with ``seq_shard_attn`` at N = 2 against the reference's decode (logits
within 1e-4, the reference's bound in ``tests/test_perf_paths.py``) and
token for token against the port's unsharded decode."""
import json
import os
import pathlib
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.configs.reduce import reduced
from repro.models import RuntimeOptions as JOpts
from repro.models import decode_step as jdecode_step
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro.models import prefill as jprefill
import repro_torch.models as tm
from repro_torch.configs import get_config as tget
from repro_torch.configs.reduce import reduced as treduced
from repro_torch.kernels.sharded import ShardGroup
from repro_torch.launch.ranks import run_ranks
from repro_torch.models.seq_shard_attn import length_slice

import torch_ep_ranks as ranks

torch.set_num_threads(2)

HERE = pathlib.Path(__file__).resolve().parent
TIMEOUT_S = 120.0
NS = (1, 2, 4)
B, H, HKV, DH, L = 2, 4, 2, 16, 32
# (pos, softcap, window): the write lands on the first, a middle and the
# last rank's range; one soft-capped and windowed case
CASES = [(5, 0.0, 0), (13, 0.0, 0), (31, 0.0, 0), (20, 30.0, 8)]


def _arrays(seed: int):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s, dtype=np.float32)  # noqa: E731
    return {"q": f(B, 1, H, DH), "k": f(B, 1, HKV, DH), "v": f(B, 1, HKV, DH),
            "ck": f(B, L, HKV, DH), "cv": f(B, L, HKV, DH)}


def _ref(tasks, arrays):
    """Run ``torch_ref_mesh.py`` on ``tasks``: (results, arrays)."""
    with tempfile.TemporaryDirectory() as tmp:
        jf, of = pathlib.Path(tmp, "job.json"), pathlib.Path(tmp, "out.json")
        af = pathlib.Path(tmp, "in.npz")
        jf.write_text(json.dumps(tasks))
        np.savez(af, **arrays)
        env = dict(os.environ, PYTHONPATH=str(HERE.parent / "src"))
        subprocess.run([sys.executable, str(HERE / "torch_ref_mesh.py"),
                        str(jf), str(of), str(af)], check=True, timeout=300,
                       env=env)
        out = json.loads(of.read_text())
        npz = dict(np.load(str(of) + ".npz"))
    return out, npz


@pytest.fixture(scope="module")
def reference():
    """The reference's (out, ck, cv) of every (case, N), one subprocess;
    all cases share the arrays of seed 0."""
    tasks = [{"task": "seq_shard", "n": n, "scale": DH ** -0.5,
              "softcap": sc, "window": w, "pos": pos}
             for pos, sc, w in CASES for n in NS]
    _, npz = _ref(tasks, _arrays(0))
    out = {}
    i = 0
    for case in CASES:
        for n in NS:
            out[case, n] = tuple(npz[f"{i}.{k}"] for k in ("out", "ck", "cv"))
            i += 1
    return out


@pytest.fixture(scope="module", params=NS)
def port(request):
    """The port's (out, ck slice, cv slice) of every case on each rank,
    from one spawned group of N ranks."""
    n = request.param
    res = run_ranks(ranks.seq_attn, n, (n, _arrays(0), CASES, DH ** -0.5),
                    timeout=TIMEOUT_S)
    return n, {case: [r[i] for r in res] for i, case in enumerate(CASES)}


@pytest.mark.parametrize("case", CASES)
def test_seq_shard_attention_matches_reference(reference, port, case):
    n, got = port
    want_out, want_ck, want_cv = reference[case, n]
    Ll = L // n
    for r, (out, ck, cv) in enumerate(got[case]):
        np.testing.assert_allclose(out, want_out, atol=1e-5, rtol=1e-5)
        assert np.array_equal(ck, want_ck[:, r * Ll:(r + 1) * Ll])
        assert np.array_equal(cv, want_cv[:, r * Ll:(r + 1) * Ll])


def test_length_slice_and_refusals():
    """length_slice cuts every k/v leaf's length axis to the rank's range
    (stacked and head-layer caches), and refuses an int8 cache and a
    length that does not divide."""
    g = ShardGroup(None, 1, 2, torch.device("cpu"))
    cache = {"stack": {"k": torch.arange(2 * 1 * 8).reshape(2, 1, 8, 1, 1),
                       "v": torch.zeros(2, 1, 8, 1, 1)},
             "head": [{"k": torch.arange(8).reshape(1, 8, 1, 1),
                       "v": torch.zeros(1, 8, 1, 1)}]}
    out = length_slice(cache, g)
    assert torch.equal(out["stack"]["k"], cache["stack"]["k"][:, :, 4:])
    assert torch.equal(out["head"][0]["k"], cache["head"][0]["k"][:, 4:])
    with pytest.raises(ValueError, match="divide"):
        length_slice({"stack": {"k": torch.zeros(1, 1, 7, 1, 1)}}, g)
    with pytest.raises(ValueError, match="int8"):
        length_slice({"stack": {"k": torch.zeros(1, 1, 8, 1, 1),
                                "k_scale": torch.ones(1, 1)}}, g)


# --------------------------- reduced gemma3-1b -------------------------- #

S, NEW, MAXLEN = 12, 6, 32


@pytest.fixture(scope="module")
def gemma():
    jcfg = reduced(get_config("gemma3-1b"), d_model=64, vocab=128,
                   n_layers=6)
    cfg = treduced(tget("gemma3-1b"), d_model=64, vocab=128, n_layers=6)
    jp = jinit_params(jcfg, jax.random.PRNGKey(0), JOpts(dtype="float32"))
    np_params = jax.tree_util.tree_map(np.asarray, jp)
    tokens = np.random.default_rng(3).integers(1, 128, size=(2, S)) \
        .astype(np.int32)
    return jcfg, cfg, jp, np_params, tokens


def _reference_decode(jcfg, jp, tokens):
    """The reference's greedy decode (one device): logits (NEW, B, V)."""
    opts = JOpts(dtype="float32")
    cache = jinit_cache(jcfg, tokens.shape[0], MAXLEN, opts)
    logits, cache = jprefill(jcfg, jp, jnp.asarray(tokens), cache, opts)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    out = []
    for j in range(NEW):
        logits, cache = jdecode_step(jcfg, jp, tok, jnp.int32(S + j), cache,
                                     opts)
        out.append(np.asarray(logits))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
    return np.stack(out)


def test_gemma3_seq_shard_decode_matches_reference(gemma):
    """N = 2: every step's logits within 1e-4 of the reference's, the
    greedy tokens equal the port's unsharded decode, and each rank's cache
    is its half of the unsharded cache (the prefilled positions
    bitwise)."""
    jcfg, cfg, jp, np_params, tokens = gemma
    want = _reference_decode(jcfg, jp, tokens)
    outs = run_ranks(ranks.seq_decode, 2,
                     (2, cfg, np_params, tokens, MAXLEN, NEW),
                     timeout=TIMEOUT_S)
    # the port's unsharded decode on the same weights
    params = tm.params_from_numpy(np_params, device="cpu")
    opts = tm.RuntimeOptions(dtype="float32")
    cache = tm.init_cache(cfg, 2, MAXLEN, opts, "cpu")
    logits, cache = tm.prefill(cfg, params, torch.from_numpy(tokens), cache,
                               opts)
    tok = logits.argmax(-1).to(torch.int32)
    plain = []
    for j in range(NEW):
        logits, cache = tm.decode_step(cfg, params, tok, S + j, cache, opts)
        plain.append(logits.argmax(-1).numpy())
        tok = logits.argmax(-1).to(torch.int32)
    half = MAXLEN // 2
    for r, (logits_r, cache_r) in enumerate(outs):
        np.testing.assert_allclose(logits_r, want, atol=1e-4, rtol=1e-4)
        assert np.array_equal(logits_r.argmax(-1), np.stack(plain))
        for name in ("k", "v"):
            whole = cache["stack"][name].numpy()
            mine = whole[:, :, r * half:(r + 1) * half]
            # the replicated prefill's positions are bitwise the unsharded
            # cache's; the decoded ones follow attention outputs that sum
            # in another order, so they agree to the logits' bound
            pre = max(0, min(S - r * half, half))
            assert np.array_equal(cache_r[name][:, :, :pre],
                                  mine[:, :, :pre])
            np.testing.assert_allclose(cache_r[name], mine, atol=1e-4,
                                       rtol=1e-4)
