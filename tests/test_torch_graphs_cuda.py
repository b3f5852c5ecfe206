"""CUDA-graph capture of the engines' blocks on the card: llama3.2-1b at
full width cut to 2 layers, bf16, served captured (the default on the
card) and eager (``graphs=False``) with equal tokens, counters and
launches: the continuous engine (native, int8, n-gram k=4, sampled), the
static engine (greedy native and int8 waves of two shapes, a sampled
wave) and the model draft (self-draft, k=4, with ``draft.passes``); one
paged decode block and one static K=8 block each replayed twice from one
cache state bitwise equal to its eager run. Every test is marked ``cuda``
and skips without a card; the file imports no JAX, so it runs on a
machine that has none:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_graphs_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.models as tm
from repro_torch.configs import get_config
from repro_torch.kernels import entries
from repro_torch.serving import ServeEngine
from repro_torch.serving.graphs import BlockGraphs

torch.set_num_threads(2)

COUNTERS = ("new_tokens", "requests", "decode_steps", "preemptions",
            "prefill_tokens_computed", "cached_prefix_tokens",
            "pages_deduped", "cow_copies", "peak_pages_used",
            "prefill_compiles", "host_syncs", "decode_compiles",
            "draft_proposed", "draft_accepted", "spec_blocks")
RUNS = {"native": dict(kv_policy="native"),
        "int8": dict(kv_policy="int8"),
        "ngram": dict(spec_mode="ngram", spec_k=4),
        "sampled": dict(temperature=0.8, top_k=50, top_p=0.9,
                        sample_seed=7)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def llama(cuda_device):
    cfg = dataclasses.replace(get_config("llama3.2-1b"), n_layers=2)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    return cfg, tm.init_params(cfg, gen, "bfloat16", cuda_device)


def _requests(vocab):
    rng = np.random.default_rng(0)
    doc = rng.integers(1, vocab, size=64).tolist()
    return [doc + rng.integers(1, vocab, size=int(n)).tolist() if i % 2
            else rng.integers(1, vocab, size=int(n)).tolist()
            for i, n in enumerate(rng.integers(20, 120, size=8))]


def _launches() -> dict:
    return {n: (fn.launches, dict(fn.launches_by_heads))
            for n, fn in entries().items()}


def _serve(cfg, params, graphs, kw):
    eng = ServeEngine(cfg, params, tm.RuntimeOptions(dtype="bfloat16"),
                      device="cuda", scheduler="continuous", page_size=16,
                      max_batch=8, prefill_chunk=64, decode_lookahead=8,
                      max_len=256, graphs=graphs, **kw)
    before = _launches()
    outs = eng.serve(_requests(cfg.vocab), 24)
    after = _launches()
    delta = {n: (after[n][0] - before[n][0],
                 {h: c - before[n][1].get(h, 0) for h, c in after[n][1].items()})
             for n in after}
    assert eng.trace_report["ok"] and eng.kv_manager.n_used == 0
    return eng, outs, delta


@pytest.mark.cuda
@pytest.mark.parametrize("run", list(RUNS))
def test_captured_serve_equals_eager(llama, run):
    cfg, params = llama
    kw = dict(RUNS[run], overlap=False)
    eager, want, want_l = _serve(cfg, params, False, kw)
    eng, got, got_l = _serve(cfg, params, None, kw)
    assert eager.graphs is None and eng.graphs is not None
    assert got == want
    assert got_l == want_l
    assert ({c: getattr(eng.stats, c) for c in COUNTERS}
            == {c: getattr(eager.stats, c) for c in COUNTERS})
    assert eng.graphs.captures == (eng.stats.decode_compiles
                                   + eng.stats.prefill_compiles)
    n = eng.graphs.captures
    assert eng.serve(_requests(cfg.vocab), 24) == got
    assert eng.graphs.captures == n


@pytest.mark.cuda
def test_two_replays_bitwise(llama):
    """One K=8 decode block over 8 slots of 100 cached tokens: its eager
    run and two replays from the same pool state give the same tokens and
    pool bitwise."""
    cfg, params = llama
    opts = tm.RuntimeOptions(dtype="bfloat16")
    B, K, ps, n_pp = 8, 8, 16, 8
    pool = tm.init_paged_cache(cfg, B * n_pp + 1, ps, opts, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    for t in pool["stack"].values():
        t.copy_(torch.randn(t.shape, generator=gen, device="cuda"))
    start = {n: t.clone() for n, t in pool["stack"].items()}
    inputs = dict(tokens=np.arange(1, B + 1, dtype=np.int32),
                  seq_lens=np.full((B,), 100, np.int32),
                  tables=np.arange(1, B * n_pp + 1, dtype=np.int32)
                  .reshape(B, n_pp),
                  done=np.zeros((B,), bool),
                  quota=np.full((B,), K, np.int32))

    def block(tokens, seq_lens, tables, done, quota):
        return tm.decode_steps_paged(cfg, params, tokens, seq_lens, tables,
                                     pool, K, opts, done=done,
                                     quota=quota)[0]
    runner = BlockGraphs("cuda")
    results = []
    for i in range(3):
        for n, t in pool["stack"].items():
            t.copy_(start[n])
        toks = runner.run("block", block, **inputs).clone()
        torch.cuda.synchronize()
        results.append((toks, {n: t.clone() for n, t in
                               pool["stack"].items()}))
        runner.capture_pending()
    assert runner.captures == 1
    for toks, rows in results[1:]:
        assert torch.equal(toks, results[0][0])
        for n, t in rows.items():
            assert torch.equal(t, results[0][1][n]), n


def _static(cfg, params, graphs, policy):
    eng = ServeEngine(cfg, params, tm.RuntimeOptions(dtype="bfloat16"),
                      device="cuda", scheduler="static", kv_policy=policy,
                      decode_lookahead=8, max_len=160, graphs=graphs)
    rng = np.random.default_rng(3)
    reqs = [rng.integers(1, cfg.vocab, size=n).tolist()
            for n in (40, 40, 40, 96, 96)]
    before = _launches()
    outs = [eng.serve([r[:] for r in reqs], 20),
            eng.generate(np.asarray(reqs[:3]), 12, greedy=False, seed=2)]
    after = _launches()
    return eng, outs, {n: after[n][0] - before[n][0] for n in after}


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["native", "int8"])
def test_captured_static_serve_equals_eager(llama, policy):
    cfg, params = llama
    eager, want, want_l = _static(cfg, params, False, policy)
    eng, got, got_l = _static(cfg, params, None, policy)
    assert eager.static_graphs is None and eng.static_graphs is not None
    assert got == want and got_l == want_l
    assert ({c: getattr(eng.stats, c) for c in COUNTERS}
            == {c: getattr(eager.stats, c) for c in COUNTERS})
    # two greedy wave shapes, each with blocks of 8 and a tail of 4 (20
    # new tokens), and the sampled wave's one-token step
    assert eng.static_graphs.captures == 5


@pytest.mark.cuda
def test_captured_draft_serve_equals_eager(llama):
    cfg, params = llama
    kw = dict(spec_mode="model", spec_k=4, draft_cfg=cfg,
              draft_params=params, overlap=False)
    eager, want, want_l = _serve(cfg, params, False, kw)
    eng, got, got_l = _serve(cfg, params, None, kw)
    assert eager.drafter.graphs is None and eng.drafter.graphs is not None
    assert got == want and got_l == want_l
    assert ({c: getattr(eng.stats, c) for c in COUNTERS}
            == {c: getattr(eager.stats, c) for c in COUNTERS})
    assert eng.drafter.passes == eager.drafter.passes
    g = eng.drafter.graphs
    assert g.captures == len(g._blocks) > 0
    n = (eng.graphs.captures, g.captures)
    assert eng.serve(_requests(cfg.vocab), 24) == got
    assert (eng.graphs.captures, g.captures) == n


@pytest.mark.cuda
def test_two_static_replays_bitwise(llama):
    """One K=8 static block (B=4, 100 cached positions of a seeded random
    cache) at a device position: its eager run and two replays from the
    same cache state give the same tokens and cache bitwise."""
    cfg, params = llama
    opts = tm.RuntimeOptions(dtype="bfloat16")
    cache = tm.init_cache(cfg, 4, 120, opts, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(2)
    for t in cache["stack"].values():
        t.copy_(torch.randn(t.shape, generator=gen, device="cuda"))
    start = {n: t.clone() for n, t in cache["stack"].items()}

    def block(tok, pos):
        return tm.decode_steps(cfg, params, tok, pos, cache, 8, opts)[0]
    runner = BlockGraphs("cuda")
    results = []
    for _ in range(3):
        for n, t in cache["stack"].items():
            t.copy_(start[n])
        toks = runner.run("block", block,
                          tok=np.arange(1, 5, dtype=np.int32),
                          pos=np.asarray(100, np.int32)).clone()
        torch.cuda.synchronize()
        results.append((toks, {n: t.clone() for n, t in
                               cache["stack"].items()}))
        runner.capture_pending()
    assert runner.captures == 1
    for toks, rows in results[1:]:
        assert torch.equal(toks, results[0][0])
        for n, t in rows.items():
            assert torch.equal(t, results[0][1][n]), n
