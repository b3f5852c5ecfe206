"""Speculative decoding in the port (repro_torch) against the reference
(repro, attn_impl="xla"), on the CPU.

The verify attention's plain version against the reference's Pallas
kernel in interpret mode; the model's verify pass against the reference's
on the same weights and pool; the n-gram and model drafters; and the
continuous engine with ``spec_mode`` "ngram" (k in {1, 4}) and "model" at
temperature 0, token for token and counter for counter against the
reference engine (both with overlap=False, so block composition does not
depend on measured wall time). Sampling engines are held to themselves:
the same ``sample_seed`` repeats, another differs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.decode_attention as da
import repro_torch.kernels.decode_attention as tk
import repro_torch.models as tm
from repro.configs import get_config
from repro.configs.reduce import reduced
from repro.models import RuntimeOptions
from repro.models import lm as jlm
from repro.serving import ModelDraft as JaxModelDraft
from repro.serving import Request as JaxRequest
from repro.serving import ServeEngine as JaxEngine
from repro_torch.configs import get_config as tget
from repro_torch.configs.reduce import reduced as treduced
from repro_torch.models import lm as tlm
from repro_torch.serving import Request, ServeEngine
from repro_torch.serving.draft import ModelDraft, NGramDraft

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
# the settings of the reference's spec engine tests
KW = dict(max_len=96, max_batch=2, scheduler="continuous", page_size=8,
          prefill_chunk=16)
NEW = 10
COUNTERS = ("host_syncs", "draft_proposed", "draft_accepted", "spec_blocks",
            "decode_steps", "prefill_tokens_computed", "peak_pages_used",
            "preemptions", "new_tokens")


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ------------------------- verify attention ----------------------------- #

def _verify_inputs(seed, B, C, H, Hkv, dh, ps, lens, npp=None):
    L = max(l + C for l in lens)
    npp = npp or -(-L // ps) + 1
    P = B * npp + 1
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, C, H, dh), dtype=np.float32)
    kp = rng.standard_normal((P, ps, Hkv, dh), dtype=np.float32)
    vp = rng.standard_normal((P, ps, Hkv, dh), dtype=np.float32)
    pt = (rng.permutation(P - 1)[:B * npp].reshape(B, npp) + 1).astype(
        np.int32)
    return q, kp, vp, pt


@pytest.mark.parametrize("B,H,Hkv,dh,ps,C,lens,fed", [
    (2, 8, 2, 64, 16, 8, (40, 17), (8, 5)),   # GQA, ragged starts
    (1, 4, 1, 128, 16, 4, (30,), (3,)),       # MQA, window crosses a page
    (2, 4, 4, 64, 8, 8, (8, 15), (1, 8)),     # MHA, fed=1 == plain decode
    (3, 4, 4, 16, 4, 5, (0, 9, 22), (1, 5, 2)),  # the engine's C=5; a row
])                                               # at seq_len 0
def test_spec_verify_plain_matches_pallas(B, H, Hkv, dh, ps, C, lens, fed):
    """Every row, pad rows included (they see the last fed row's
    frontier), against the reference kernel in interpret mode."""
    q, kp, vp, pt = _verify_inputs(0, B, C, H, Hkv, dh, ps, lens)
    sl = np.asarray(lens, np.int32)
    nf = np.asarray(fed, np.int32)
    want = da.spec_verify_attention(*map(jnp.asarray, (q, kp, vp, pt, sl,
                                                       nf)), interpret=True)
    got = tk.spec_verify_attention(*map(_t, (q, kp, vp, pt, sl, nf)))
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_spec_verify_plain_int8():
    B, C, H, Hkv, dh, ps = 1, 8, 8, 2, 64, 32
    q, kp, vp, _ = _verify_inputs(1, B, C, H, Hkv, dh, ps, (40,), npp=4)
    pt = np.asarray([[2, 3, 1]], np.int32)
    sl, nf = np.asarray([40], np.int32), np.asarray([8], np.int32)
    ki, vi, ksc, vsc = map(np.asarray, da.quantize_kv(jnp.asarray(kp),
                                                      jnp.asarray(vp)))
    want = da.spec_verify_attention(
        *map(jnp.asarray, (q, ki, vi, pt, sl, nf)), k_scale=jnp.asarray(ksc),
        v_scale=jnp.asarray(vsc), interpret=True)
    got = tk.spec_verify_attention(*map(_t, (q, ki, vi, pt, sl, nf)),
                                   k_scale=_t(ksc), v_scale=_t(vsc))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_spec_verify_rows_ignore_later_draft_kv():
    """Corrupting the KV of the last fed position changes only the last
    fed row (the window spans a page boundary)."""
    B, C, H, Hkv, dh, ps = 1, 4, 4, 2, 64, 4
    q, kp, vp, _ = _verify_inputs(2, B, C, H, Hkv, dh, ps, (6,), npp=4)
    pt = np.asarray([[1, 2, 3, 4]], np.int32)
    sl, nf = np.asarray([6], np.int32), np.asarray([4], np.int32)
    base = tk.spec_verify_attention_plain(*map(_t, (q, kp, vp, pt, sl, nf)))
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[3, 1], vp2[3, 1] = 100.0, -100.0   # token 9: page 2 (id 3), slot 1
    out = tk.spec_verify_attention_plain(*map(_t, (q, kp2, vp2, pt, sl,
                                                   nf)))
    np.testing.assert_allclose(out[:, :3].numpy(), base[:, :3].numpy(),
                               **TOL)
    assert float((out[:, 3] - base[:, 3]).abs().max()) > 1.0


# ---------------------------- model layer ------------------------------- #

@pytest.fixture(scope="module")
def models():
    cfg = reduced(get_config("llama3.2-1b"), d_model=64, n_layers=2,
                  vocab=128)
    tcfg = treduced(tget("llama3.2-1b"), d_model=64, n_layers=2, vocab=128)
    dcfg = reduced(get_config("llama3.2-1b"), d_model=32, n_layers=1,
                   vocab=128)
    tdcfg = treduced(tget("llama3.2-1b"), d_model=32, n_layers=1, vocab=128)
    opts = RuntimeOptions(dtype="float32")
    jp = jlm.init_params(cfg, jax.random.PRNGKey(0), opts)
    jdp = jlm.init_params(dcfg, jax.random.PRNGKey(1), opts)
    return dict(cfg=cfg, tcfg=tcfg, dcfg=dcfg, tdcfg=tdcfg, jp=jp, jdp=jdp,
                tp=tm.params_from_numpy(_np(jp), device="cpu"),
                tdp=tm.params_from_numpy(_np(jdp), device="cpu"))


@pytest.mark.parametrize("cache_dtype", ["", "int8"])
def test_decode_verify_paged_matches(models, cache_dtype):
    """One prefill chunk, then a ragged verify window (fed 5 and 2 of 5)
    over the same pool: logits of the fed rows and the whole pool agree
    with the reference's."""
    cfg, tcfg, jp, tp = models["cfg"], models["tcfg"], models["jp"], \
        models["tp"]
    jo = RuntimeOptions(dtype="float32", cache_dtype=cache_dtype)
    to = tlm.RuntimeOptions(dtype="float32", cache_dtype=cache_dtype)
    B, ps, npp, C = 2, 4, 6, 8
    P = B * npp + 1
    rng = np.random.default_rng(3)
    pt = (rng.permutation(P - 1)[:B * npp].reshape(B, npp) + 1).astype(
        np.int32)
    lens = np.asarray([7, 5], np.int32)
    toks = rng.integers(1, cfg.vocab, size=(B, C)).astype(np.int32)
    win = rng.integers(1, cfg.vocab, size=(B, 5)).astype(np.int32)
    fed = np.asarray([5, 2], np.int32)
    jc = jlm.init_paged_cache(cfg, P, ps, jo)
    _, jc = jlm.prefill_paged_chunk(cfg, jp, jnp.asarray(toks), jc,
                                    jnp.asarray(pt), jnp.int32(0),
                                    jnp.asarray(lens), jo,
                                    calibrate=cache_dtype == "int8")
    jl, jc = jlm.decode_verify_paged(cfg, jp, jnp.asarray(win),
                                     jnp.asarray(lens), jnp.asarray(fed),
                                     jnp.asarray(pt), jc, jo)
    tc = tlm.init_paged_cache(tcfg, P, ps, to, device="cpu")
    _, tc = tlm.prefill_paged_chunk(tcfg, tp, _t(toks), tc, _t(pt), 0,
                                    _t(lens), to,
                                    calibrate=cache_dtype == "int8")
    n0 = tk.spec_verify_attention.launches
    tl, tc = tlm.decode_verify_paged(tcfg, tp, _t(win), _t(lens), _t(fed),
                                     _t(pt), tc, to)
    assert tk.spec_verify_attention.launches == n0   # plain version on CPU
    for b in range(B):
        np.testing.assert_allclose(tl[b, :fed[b]].numpy(),
                                   np.asarray(jl[b, :fed[b]]), **MODEL_TOL)
    for name, arr in jc["stack"].items():
        got = tc["stack"][name].numpy()
        if arr.dtype == jnp.int8:
            np.testing.assert_array_equal(got, np.asarray(arr), err_msg=name)
        else:
            np.testing.assert_allclose(got, np.asarray(arr), **MODEL_TOL,
                                       err_msg=name)


def test_verify_routes_to_spec_entry(models, monkeypatch):
    """The verify pass reaches ``spec_verify_attention`` (never the
    prefill entry) and a prefill chunk the reverse, although both pass a
    (B,) start."""
    calls = []
    for name in ("spec_verify_attention", "chunk_prefill_attention"):
        fn = getattr(tk, name)
        monkeypatch.setattr(tk, name, lambda *a, _f=fn, _n=name, **k: (
            calls.append(_n), _f(*a, **k))[1])
    tcfg, tp = models["tcfg"], models["tp"]
    to = tlm.RuntimeOptions(dtype="float32")
    cache = tlm.init_paged_cache(tcfg, 5, 4, to, device="cpu")
    pt = torch.tensor([[1, 2, 3, 4]], dtype=torch.int32)
    tlm.prefill_paged_chunk(tcfg, tp, torch.ones((1, 8), dtype=torch.int32),
                            cache, pt, 0, torch.tensor([6], dtype=torch.int32),
                            to)
    assert calls == ["chunk_prefill_attention"] * tcfg.n_layers
    calls.clear()
    tlm.decode_verify_paged(tcfg, tp, torch.ones((1, 4), dtype=torch.int32),
                            torch.tensor([6], dtype=torch.int32),
                            torch.tensor([3], dtype=torch.int32), pt, cache,
                            to)
    assert calls == ["spec_verify_attention"] * tcfg.n_layers


# ------------------------------ drafters -------------------------------- #

def test_ngram_draft_unrolls_loops_and_prefers_longest():
    d = NGramDraft(max_ngram=3, min_ngram=1)
    req = Request(rid=0, prompt=[9, 1, 2, 1, 2, 1, 2], max_new_tokens=8)
    assert d.propose(req, 6) == [1, 2, 1, 2, 1, 2]
    assert d.propose(Request(rid=1, prompt=[3, 4, 5], max_new_tokens=8),
                     4) == []
    req = Request(rid=2, prompt=[7, 8, 5, 0, 8, 6, 0, 7, 8],
                  max_new_tokens=4)
    assert d.propose(req, 1) == [5]
    d.drop(0)
    assert 0 not in d._idx and 0 not in d._seen


def test_model_draft_sync_catchup_propose(models):
    """Admit syncs to the target's landed extent, catch-up absorbs
    committed tokens, propose returns k tokens and rolls its reservation
    back — with the reference drafter's proposals at every step."""
    dcfg, tdcfg = models["dcfg"], models["tdcfg"]
    jd = JaxModelDraft(dcfg, models["jdp"], page_size=4, max_batch=2,
                       max_len=32)
    d = ModelDraft(tdcfg, models["tdp"], page_size=4, max_batch=2,
                   max_len=32, device="cpu")
    req = Request(rid=7, prompt=[3, 1, 4, 1, 5], max_new_tokens=8)
    jreq = JaxRequest(rid=7, prompt=[3, 1, 4, 1, 5], max_new_tokens=8)
    out = d.propose_all([(req, 3)])
    assert out == jd.propose_all([(jreq, 3)])
    assert set(out) == {7} and len(out[7]) == 3
    assert d.kv.seq_len(7) == len(req.prefill_tokens) - 1   # rolled back
    req.out.extend([9, 2])                     # target committed 2 tokens
    jreq.out.extend([9, 2])
    out2 = d.propose_all([(req, 3)])
    assert out2 == jd.propose_all([(jreq, 3)])
    assert d.kv.seq_len(7) == len(req.prefill_tokens) - 1   # caught up
    assert d.take_host_syncs() == 2 and d.take_host_syncs() == 0
    assert d.propose_all([(req, 3)])[7] == out2[7]   # deterministic
    d.drop(7)
    assert d.kv.n_used == 0


# ---------------------------- the engine -------------------------------- #

def _requests():
    rng = np.random.default_rng(0)
    doc = rng.integers(1, 120, size=40).tolist()
    return [doc + rng.integers(1, 120, size=5).tolist() for _ in range(3)]


VARIANTS = {"ngram-k1": dict(spec_mode="ngram", spec_k=1),
            "ngram-k4": dict(spec_mode="ngram", spec_k=4),
            "model-k4": dict(spec_mode="model", spec_k=4)}


@pytest.fixture(scope="module")
def reference(models):
    """The reference engine's outputs and counters, once per variant."""
    runs = {}
    for name, kw in VARIANTS.items():
        if kw["spec_mode"] == "model":
            kw = dict(kw, draft_cfg=models["dcfg"],
                      draft_params=models["jdp"])
        eng = JaxEngine(models["cfg"], models["jp"],
                        RuntimeOptions(dtype="float32"), **KW, **kw,
                        overlap=False)
        outs = eng.serve(_requests(), NEW)
        runs[name] = (outs, {c: getattr(eng.stats, c) for c in COUNTERS})
    return runs


def _port(models, **kw):
    if kw.get("spec_mode") == "model":
        kw = dict(kw, draft_cfg=models["tdcfg"], draft_params=models["tdp"])
    args = dict(KW, device="cpu", overlap=False)
    args.update(kw)
    return ServeEngine(models["tcfg"], models["tp"],
                       tm.RuntimeOptions(dtype="float32"), **args)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_spec_engine_matches_reference(models, reference, variant):
    want, want_stats = reference[variant]
    eng = _port(models, **VARIANTS[variant])
    n0 = tk.spec_verify_attention.launches
    got = eng.serve(_requests(), NEW)
    assert got == want
    assert {c: getattr(eng.stats, c) for c in COUNTERS} == want_stats
    assert eng.stats.spec_blocks > 0
    assert eng.trace_report["ok"] and eng.kv_manager.n_used == 0
    assert tk.spec_verify_attention.launches == n0   # CPU: plain version


def test_spec_engine_equals_spec_off(models):
    """Spec-on at temperature 0 is token-identical to spec-off, with the
    default overlapped streams, and drafts land."""
    want = _port(models, overlap=True).serve(_requests(), NEW)
    eng = _port(models, spec_mode="ngram", spec_k=4, overlap=True)
    assert eng.serve(_requests(), NEW) == want
    assert eng.stats.draft_accepted > 0
    assert 0.0 < eng.stats.acceptance_rate <= 1.0
    assert eng.trace_report["ok"]


def test_self_draft_accepts_nearly_all(models):
    """The target drafting for itself proposes what it would decode: the
    draft's decode path and the target's verify path must agree, so
    nearly every proposal is accepted (the same gate the chip run holds
    at full width)."""
    want = _port(models).serve(_requests(), NEW)
    eng = _port(models, spec_mode="model", spec_k=4)
    eng.draft_cfg, eng.draft_params = models["tcfg"], models["tp"]
    assert eng.serve(_requests(), NEW) == want
    assert eng.stats.acceptance_rate >= 0.9
    assert eng.trace_report["ok"] and eng.kv_manager.n_used == 0


@pytest.mark.parametrize("spec", [dict(), dict(spec_mode="ngram", spec_k=4)])
def test_sampling_engine_repeats_under_its_seed(models, spec):
    kw = dict(temperature=0.8, top_k=50, top_p=0.9, **spec)
    runs = {}
    for seed in (3, 3, 4):
        eng = _port(models, sample_seed=seed, **kw)
        out = eng.serve(_requests(), NEW)
        assert eng.trace_report["ok"] and eng.kv_manager.n_used == 0
        assert all(len(o) == NEW and all(0 <= t < 128 for t in o)
                   for o in out)
        runs.setdefault(seed, []).append(out)
    assert runs[3][0] == runs[3][1]
    assert runs[3][0] != runs[4][0]
    greedy = _port(models, **spec).serve(_requests(), NEW)
    assert runs[3][0] != greedy


def test_spec_flag_validation(models):
    tcfg, tp = models["tcfg"], models["tp"]
    mk = lambda **kw: ServeEngine(tcfg, tp, device="cpu", max_len=64,
                                  scheduler="continuous", **kw)
    with pytest.raises(ValueError, match="spec_mode"):
        mk(spec_mode="banana")
    with pytest.raises((ValueError, NotImplementedError), match="continuous"):
        ServeEngine(tcfg, tp, device="cpu", max_len=64, scheduler="static",
                    spec_mode="ngram")
    with pytest.raises(ValueError, match="draft_cfg"):
        mk(spec_mode="model")                  # model mode needs a config
    with pytest.raises(ValueError, match="draft_cfg"):
        mk(draft_cfg=tcfg)                     # config needs model mode
    with pytest.raises(ValueError, match="temperature"):
        mk(top_k=5)                            # filters need temperature
    with pytest.raises(ValueError, match="temperature"):
        mk(temperature=-0.5)
    with pytest.raises(ValueError, match="top_p"):
        mk(temperature=1.0, top_p=0.0)
    with pytest.raises(ValueError, match="spec_k"):
        mk(spec_mode="ngram", spec_k=0)


@pytest.mark.parametrize("flags,line", [
    (["--spec-mode", "ngram", "--spec-k", "4", "--shared-doc", "12"],
     "[serve] spec: mode=ngram k=4"),
    (["--temperature", "0.8", "--top-p", "0.9"], "[serve] first output"),
])
def test_serve_cli_spec_and_sampling(capsys, flags, line):
    from repro_torch.launch import serve as tserve
    tserve.main(["--arch", "llama3.2-1b", "--reduced", "--d-model", "64",
                 "--device", "cpu", "--scheduler", "continuous",
                 "--concurrency", "3", "--prompt-len",
                 "16", "--new-tokens", "6", *flags])
    out = capsys.readouterr().out
    assert line in out
    if "spec" in line:
        assert "accept_rate=" in out and "blocks=0 " not in out

