"""The static engine's decode blocks and the model draft's three blocks
through the CUDA-graph runner (``repro_torch.serving.graphs``), on the
CPU.

(a) Every family's dense-cache decode (``models.decode_steps`` and
``models.decode_step``) with its position as a 0-d and as a (1,) int32
tensor, against a host int, bitwise in tokens, logits and every cache
leaf, native and int8 where the family takes int8; the masked attention
with a tensor ``q_offset`` in both of its branches; llama's device-
position block against the reference's ``jax.jit`` ``decode_steps`` on the
same weights. (b) ``reset_cache`` against a fresh ``init_cache``, leaf by
leaf. (c) Two static waves of one shape on one engine (its cache reset in
place) against two fresh engines and the reference's engine. (d) The
static engine and the model draft served through the runner, with a
stand-in graph that re-runs the block on replay, against eager: tokens,
counters, ``draft.passes``, the masked attention's calls; one capture a
key; a wave of a new shape drops the old static graphs and never the
continuous ones. (e) Two serves with ``spec_mode="model"`` on one engine
(the draft kept and reset) against two fresh engines and the reference's
engine. The card's own cases are in ``tests/test_torch_graphs_cuda.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.configs.reduce import reduced
from repro.models import RuntimeOptions
from repro.models import api as japi
from repro.serving import ServeEngine as JaxEngine
import repro_torch.models as tm
from repro_torch.configs import get_config as tget
from repro_torch.configs.reduce import reduced as treduced
from repro_torch.models import common as tcm
from repro_torch.serving import ServeEngine
from repro_torch.serving import graphs as tgraphs
from repro_torch.serving.graphs import BlockGraphs

torch.set_num_threads(2)

MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
# every integer counter of ServeStats
COUNTERS = ("new_tokens", "requests", "decode_steps", "preemptions",
            "prefill_tokens_computed", "cached_prefix_tokens",
            "pages_deduped", "cow_copies", "peak_pages_used",
            "prefill_compiles", "host_syncs", "decode_compiles",
            "pages_spilled", "pages_fetched", "prefetch_hits",
            "prefetch_misses", "clean_demotions", "chiplet_promotions",
            "chiplet_demotions", "draft_proposed", "draft_accepted",
            "spec_blocks")
# arch -> layers of its reduced twin, and whether it takes an int8 cache
FAMILIES = {"llama3.2-1b": (2, True), "arctic-480b": (2, True),
            "gemma3-1b": (3, True), "deepseek-v2-236b": (3, True),
            "mamba2-130m": (2, False), "zamba2-2.7b": (2, False),
            "whisper-medium": (2, False)}
CASES = [(arch, cache) for arch, (_, int8) in FAMILIES.items()
         for cache in (("", "int8") if int8 else ("",))]


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _counters(eng) -> dict:
    return {c: getattr(eng.stats, c) for c in COUNTERS}


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k],
                                                          f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _leaves(v, f"{path}/{i}")]
    return [(path, tree)]


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()


def _same_tree(got, want):
    g, w = _leaves(got), _leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        assert a.dtype == b.dtype and torch.equal(a, b), path


# ------------------------ (a) the device position ------------------------ #

@functools.lru_cache(maxsize=None)
def _family(arch):
    n_layers, _ = FAMILIES[arch]
    cfg = treduced(tget(arch), d_model=64, vocab=128, n_layers=n_layers)
    gen = torch.Generator().manual_seed(5)
    return cfg, tm.init_params(cfg, gen, "float32", "cpu")


def _prefilled(arch, cache_dtype):
    """A wave of 2 x 10 tokens (after Whisper's frames) prefilled into a
    cache with room for 5 more: (cfg, params, opts, cache, token, pos)."""
    cfg, params = _family(arch)
    opts = tm.RuntimeOptions(dtype="float32", cache_dtype=cache_dtype)
    rng = np.random.default_rng(2)
    toks = _t(rng.integers(1, cfg.vocab, size=(2, 10)).astype(np.int32))
    frames, pfx = None, 0
    if cfg.family == "encdec":
        frames = _t(rng.standard_normal((2, cfg.source_len, cfg.d_model),
                                        dtype=np.float32))
        pfx = cfg.source_len
    cache = tm.init_cache(cfg, 2, 10 + pfx + 5, opts, device="cpu")
    logits, cache = tm.prefill(cfg, params, toks, cache, opts, frames)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    return cfg, params, opts, cache, tok, 10 + pfx


@pytest.mark.parametrize("form", ["0-d", "(1,)"])
@pytest.mark.parametrize("arch,cache_dtype", CASES)
def test_device_position_bitwise(arch, cache_dtype, form):
    """A 4-step fused block, then one step, at a tensor position: the host
    int's tokens, logits and cache, bitwise."""
    cfg, params, opts, cache, tok, pos = _prefilled(arch, cache_dtype)
    caches = {}
    outs = {}
    for kind in ("int", form):
        c = _clone(cache)

        def at(p, kind=kind):
            if kind == "int":
                return p
            return torch.tensor(p if kind == "0-d" else [p],
                                dtype=torch.int32)
        blk, c = tm.decode_steps(cfg, params, tok, at(pos), c, 4, opts)
        logits, c = tm.decode_step(cfg, params, blk[:, -1], at(pos + 4), c,
                                   opts)
        outs[kind], caches[kind] = (blk, logits), c
    assert torch.equal(outs[form][0], outs["int"][0])
    assert torch.equal(outs[form][1], outs["int"][1])
    _same_tree(caches[form], caches["int"])


@pytest.mark.parametrize("S,L", [(1, 40), (1100, 2048)])
def test_attention_tensor_q_offset(S, L):
    """The masked attention at a tensor q_offset (0-d and (1,)) equals the
    int's, in its one-block branch and its blocked one (S * L > 1 << 21),
    sliding and causal."""
    g = torch.Generator().manual_seed(3)
    q = torch.randn((1, S, 2, 8), generator=g)
    k = torch.randn((1, L, 1, 8), generator=g)
    v = torch.randn((1, L, 1, 8), generator=g)
    off = L - S
    for kind, window in (("causal", 0), ("sliding", 24)):
        want = tcm.attention(q, k, v, mask_kind=kind, window=window,
                             q_offset=off, softcap=30.0)
        for t in (torch.tensor(off, dtype=torch.int32),
                  torch.tensor([off], dtype=torch.int32)):
            got = tcm.attention(q, k, v, mask_kind=kind, window=window,
                                q_offset=t, softcap=30.0)
            assert torch.equal(got, want), (kind, tuple(t.shape))


@pytest.fixture(scope="module")
def llama():
    cfg = reduced(get_config("llama3.2-1b"), d_model=64, n_layers=2,
                  vocab=128)
    tcfg = treduced(tget("llama3.2-1b"), d_model=64, n_layers=2, vocab=128)
    jp = japi.init_params(cfg, jax.random.PRNGKey(0),
                          RuntimeOptions(dtype="float32"))
    tp = tm.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    return cfg, tcfg, jp, tp


@pytest.mark.parametrize("cache_dtype", ["", "int8"])
def test_device_position_block_matches_reference(llama, cache_dtype):
    """llama's 4-step block at a 0-d device position against the
    reference's jitted ``decode_steps`` (its position traced) on the same
    weights and prompt: tokens equal, caches within MODEL_TOL."""
    cfg, tcfg, jp, tp = llama
    jo = RuntimeOptions(dtype="float32", cache_dtype=cache_dtype)
    to = tm.RuntimeOptions(dtype="float32", cache_dtype=cache_dtype)
    toks = np.random.default_rng(4).integers(1, cfg.vocab, size=(2, 9))
    toks = toks.astype(np.int32)
    jc = japi.init_cache(cfg, 2, 16, jo)
    jl, jc = japi.prefill(cfg, jp, jnp.asarray(toks), jc, jo)
    tc = tm.init_cache(tcfg, 2, 16, to, device="cpu")
    tl, tc = tm.prefill(tcfg, tp, _t(toks), tc, to)
    tok = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)
    block = jax.jit(functools.partial(japi.decode_steps, cfg, opts=jo),
                    static_argnames=("n_steps",))
    jt, jc = block(jp, jnp.asarray(tok), jnp.int32(9), jc, n_steps=4)
    tt, tc = tm.decode_steps(tcfg, tp, _t(tok),
                             torch.tensor(9, dtype=torch.int32), tc, 4, to)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    for name, arr in jc["stack"].items():
        got = tc["stack"][name].numpy()
        if arr.dtype == jnp.int8:
            np.testing.assert_array_equal(got, np.asarray(arr), err_msg=name)
        else:
            np.testing.assert_allclose(got, np.asarray(arr), **MODEL_TOL,
                                       err_msg=name)


# --------------------------- (b) the cache reset ------------------------- #

@pytest.mark.parametrize("arch,cache_dtype", CASES)
def test_reset_cache_gives_a_fresh_cache(arch, cache_dtype):
    """After a prefill and a decode step, ``reset_cache`` leaves every
    leaf equal to a fresh ``init_cache``'s, in the same storage."""
    cfg, params, opts, cache, tok, pos = _prefilled(arch, cache_dtype)
    tm.decode_step(cfg, params, tok, pos, cache, opts)
    ptrs = [t.data_ptr() for _, t in _leaves(cache)]
    tm.reset_cache(cache)
    assert [t.data_ptr() for _, t in _leaves(cache)] == ptrs
    fresh = tm.init_cache(cfg, 2, pos + 5, opts, device="cpu")
    _same_tree(cache, fresh)


# ------------------- (c) two waves of one shape, one engine -------------- #

def _prompts(vocab, seed, B=2, S=7):
    return np.random.default_rng(seed).integers(1, vocab, size=(B, S)) \
        .astype(np.int32)


STATIC = dict(max_len=24, scheduler="static", decode_lookahead=4)


@pytest.fixture(scope="module")
def static_reference(llama):
    """The reference's static engine: two waves of one shape, native and
    int8; tokens and counters after each."""
    cfg, _, jp, _ = llama
    out = {}
    for policy in ("native", "int8"):
        eng = JaxEngine(cfg, jp, RuntimeOptions(dtype="float32"),
                        kv_policy=policy, **STATIC)
        out[policy] = [(eng.generate(_prompts(cfg.vocab, s), 9),
                        _counters(eng)) for s in (1, 2)]
    return out


def _static_port(llama, **kw):
    _, tcfg, _, tp = llama
    return ServeEngine(tcfg, tp, tm.RuntimeOptions(dtype="float32"),
                       device="cpu", **STATIC, **kw)


@pytest.mark.parametrize("policy", ["native", "int8"])
def test_two_waves_one_engine(llama, static_reference, policy):
    """The second wave of one shape on one engine (its cache reset in
    place, not reallocated) equals a fresh engine's and the reference's
    second wave in tokens and every counter."""
    cfg = llama[0]
    eng = _static_port(llama, kv_policy=policy)
    ptr = None
    for i, (seed, (want, want_counts)) in enumerate(
            zip((1, 2), static_reference[policy])):
        got = eng.generate(_prompts(cfg.vocab, seed), 9)
        assert got == want, i
        assert _counters(eng) == want_counts, i
        p = eng._static[1]["stack"]["k"].data_ptr()
        assert ptr in (None, p)
        ptr = p
        fresh = _static_port(llama, kv_policy=policy)
        assert fresh.generate(_prompts(cfg.vocab, seed), 9) == got


# -------------------- (d) the static engine and the draft ---------------- #

class RerunGraph:
    """A stand-in for the CUDA graph that runs the block at capture and
    again on replay (its host counters put back, as a replay runs no host
    code), writing the results into the captured outputs."""
    replays = 0

    def capture(self, fn):
        self.fn = fn
        self.out = fn()
        return self.out

    def replay(self):
        RerunGraph.replays += 1
        saved = tgraphs._counts()
        new = self.fn()
        tgraphs._set_counts(saved)
        if self.out is not None:
            self.out.copy_(new)


def _runner():
    return BlockGraphs("cpu", new_graph=RerunGraph)


def _static_serve(eng, vocab):
    """Ragged requests in two wave shapes (greedy), then a sampled wave:
    outputs, counters and the masked attention's calls."""
    rng = np.random.default_rng(9)
    reqs = [rng.integers(1, vocab, size=n).tolist() for n in (6, 6, 9, 9)]
    calls = tcm.attention.calls
    outs = [eng.serve_bucketed([r[:] for r in reqs], 7),
            eng.generate(_prompts(vocab, 3), 5, greedy=False, seed=4)]
    return outs, _counters(eng), tcm.attention.calls - calls


@pytest.mark.parametrize("arch", ["llama3.2-1b", "gemma3-1b"])
def test_static_engine_through_the_runner(arch):
    """Served twice through the runner: tokens, counters and the masked
    attention's calls (gemma3's layers all take it, and it counts on the
    CPU too) equal eager; each serve captures once each distinct key it
    makes, (B, L, k_eff) of a greedy block and (B, L) of a sampled step
    (its first wave's shape is not the last one's, so the second serve
    captures them again)."""
    cfg, params = _family(arch)
    kw = dict(device="cpu", scheduler="static", max_len=40,
              decode_lookahead=4)
    eager = ServeEngine(cfg, params, tm.RuntimeOptions(dtype="float32"),
                        **kw)
    eng = ServeEngine(cfg, params, tm.RuntimeOptions(dtype="float32"), **kw)
    assert eng.static_graphs is None     # eager on the CPU by default
    eng.static_graphs = _runner()
    keys = []
    run = eng.static_graphs.run

    def record(key, fn, **inputs):
        keys[-1].append(key)
        return run(key, fn, **inputs)
    eng.static_graphs.run = record
    RerunGraph.replays = 0
    for i in range(2):
        keys.append([])
        want = _static_serve(eager, cfg.vocab)
        got = _static_serve(eng, cfg.vocab)
        assert got == want, i
        assert got[2] > 0 if arch == "gemma3-1b" else got[2] == 0
        # greedy waves of 6 and 9 tokens (7 new: k_eff 4 then 2), then a
        # sampled wave of 7 tokens (5 new)
        assert set(keys[-1]) == {("dense", 2, 15, 4), ("dense", 2, 15, 2),
                                 ("dense", 2, 18, 4), ("dense", 2, 18, 2),
                                 ("step", 2, 12)}
        assert eng.static_graphs.captures == 5 * (i + 1)
        assert set(eng.static_graphs._blocks) == {("step", 2, 12)}
    assert RerunGraph.replays > 0


def test_new_wave_shape_drops_static_graphs_only(llama):
    """A continuous serve's graphs survive static waves; a wave of a new
    shape drops the old static graphs and cache before it allocates its
    own; a wave of the same shape reuses both and captures nothing."""
    cfg, tcfg, _, tp = llama
    eng = ServeEngine(tcfg, tp, tm.RuntimeOptions(dtype="float32"),
                      device="cpu", max_len=40, page_size=4, max_batch=2,
                      prefill_chunk=8, decode_lookahead=4)
    eng.graphs, eng.static_graphs = _runner(), _runner()
    rng = np.random.default_rng(6)
    eng.serve([rng.integers(1, cfg.vocab, size=n).tolist() for n in (5, 9)],
              6)
    n_cont = len(eng.graphs)
    assert n_cont > 0
    eng.generate(_prompts(cfg.vocab, 1), 7)
    first = eng._static[1]
    assert set(eng.static_graphs._blocks) == {("dense", 2, 16, 4),
                                              ("dense", 2, 16, 2)}
    eng.generate(_prompts(cfg.vocab, 2, S=11), 7)
    assert eng._static[1] is not first
    assert set(eng.static_graphs._blocks) == {("dense", 2, 20, 4),
                                              ("dense", 2, 20, 2)}
    n = eng.static_graphs.captures
    second = eng._static[1]
    eng.generate(_prompts(cfg.vocab, 3, S=11), 7)
    assert eng._static[1] is second and eng.static_graphs.captures == n
    assert len(eng.graphs) == n_cont
    eng.params = eng.params            # new weights drop both
    assert len(eng.graphs) == len(eng.static_graphs) == 0


@pytest.fixture(scope="module")
def draft_models(llama):
    """A smaller draft (one layer of 32) in both packages, its weights the
    reference's."""
    dcfg = reduced(get_config("llama3.2-1b"), d_model=32, n_layers=1,
                   vocab=128)
    tdcfg = treduced(tget("llama3.2-1b"), d_model=32, n_layers=1, vocab=128)
    jdp = japi.init_params(dcfg, jax.random.PRNGKey(1),
                           RuntimeOptions(dtype="float32"))
    tdp = tm.params_from_numpy(jax.tree_util.tree_map(np.asarray, jdp),
                               device="cpu")
    return dcfg, tdcfg, jdp, tdp


SPEC = dict(max_len=96, max_batch=2, scheduler="continuous", page_size=8,
            prefill_chunk=16, spec_mode="model", spec_k=4, overlap=False)
SPEC_NEW = 10


def _spec_requests(seed):
    rng = np.random.default_rng(seed)
    doc = rng.integers(1, 120, size=40).tolist()
    return [doc + rng.integers(1, 120, size=5).tolist() for _ in range(3)]


def _spec_port(llama, draft_models, **kw):
    _, tcfg, _, tp = llama
    _, tdcfg, _, tdp = draft_models
    return ServeEngine(tcfg, tp, tm.RuntimeOptions(dtype="float32"),
                       device="cpu", draft_cfg=tdcfg, draft_params=tdp,
                       **SPEC, **kw)


def test_draft_through_the_runner(llama, draft_models):
    """The model-draft engine served twice through the runner (the
    engine's and its draft's, a sibling): tokens, counters and
    ``draft.passes`` equal eager; one capture a draft key; the second
    serve captures nothing."""
    eager = _spec_port(llama, draft_models)
    eng = _spec_port(llama, draft_models)
    eng.graphs = _runner()
    for i in range(2):
        want = eager.serve(_spec_requests(0), SPEC_NEW)
        got = eng.serve(_spec_requests(0), SPEC_NEW)
        assert got == want, i
        assert _counters(eng) == _counters(eager), i
        assert eng.drafter.passes == eager.drafter.passes, i
        assert eng.drafter is eng._draft and eng.drafter.graphs is not None
        g = eng.drafter.graphs
        assert g.captures == len(g) == len(g._blocks)
        assert {k[0] for k in g._blocks} == {"chunk", "catchup", "propose"}
        if i == 0:
            first = (g.captures, eng.graphs.captures)
    assert (g.captures, eng.graphs.captures) == first
    assert eng.drafter.passes["catchups"] > 0


# ----------------- (e) two model-draft serves on one engine -------------- #

@pytest.fixture(scope="module")
def spec_reference(llama, draft_models):
    cfg, _, jp, _ = llama
    dcfg, _, jdp, _ = draft_models
    eng = JaxEngine(cfg, jp, RuntimeOptions(dtype="float32"),
                    draft_cfg=dcfg, draft_params=jdp, **SPEC)
    return [(eng.serve(_spec_requests(s), SPEC_NEW), _counters(eng))
            for s in (0, 1)]


def test_two_model_draft_serves_one_engine(llama, draft_models,
                                           spec_reference):
    """The second serve on one engine (its draft kept, its pool reset in
    place) equals a fresh engine's and the reference engine's second
    serve, in tokens and every counter."""
    eng = _spec_port(llama, draft_models)
    draft = ptr = None
    for i, (seed, (want, want_counts)) in enumerate(
            zip((0, 1), spec_reference)):
        got = eng.serve(_spec_requests(seed), SPEC_NEW)
        assert got == want, i
        assert _counters(eng) == want_counts, i
        assert eng.trace_report["ok"] and eng.kv_manager.n_used == 0
        assert draft in (None, eng.drafter)
        assert ptr in (None, eng.drafter.cache["stack"]["k"].data_ptr())
        draft, ptr = eng.drafter, eng.drafter.cache["stack"]["k"].data_ptr()
        fresh = _spec_port(llama, draft_models)
        assert fresh.serve(_spec_requests(seed), SPEC_NEW) == got
        assert fresh.drafter.passes == eng.drafter.passes
