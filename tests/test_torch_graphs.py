"""CUDA-graph capture of the continuous engine's blocks
(``repro_torch.serving.graphs``), on the CPU.

The prefill chunk's start as a device tensor (0-d and (1,)) against a host
int, bitwise, and against the reference's chunk; two serves on one
continuous engine (its pool reset in place) against two fresh engines and
the reference's engine; the runner's bookkeeping through stand-ins for the
CUDA graph (one capture a key, an eager first call, exact launch counters,
inputs through the static buffers), and the whole engine served through
the runner with a stand-in that re-runs the block on replay; and
``graphs=True`` refused on the CPU, at two shards and with a MoE dispatch
other than capacity (on either engine) before any weights are drawn. The
static engine's and the model draft's blocks through the runner are in
``tests/test_torch_static_graphs.py``. The card's own cases (captured against eager at llama3.2-1b's
width, two replays bitwise) are in ``tests/test_torch_graphs_cuda.py``,
which imports no JAX."""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.configs.reduce import reduced
from repro.models import RuntimeOptions
from repro.models import lm as jlm
from repro.serving import ServeEngine as JaxEngine
import repro_torch.models as tm
from repro_torch.configs import get_config as tget
from repro_torch.configs.reduce import reduced as treduced
from repro_torch.kernels import entries
from repro_torch.kernels import sharded as ksh
from repro_torch.models import common as tcm
from repro_torch.models import lm as tlm
from repro_torch.serving import ServeEngine
from repro_torch.serving import engine as tengine
from repro_torch.serving.graphs import BlockGraphs

torch.set_num_threads(2)

MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
KW = dict(max_len=40, scheduler="continuous", page_size=4, max_batch=4,
          prefill_chunk=8, decode_lookahead=8, overlap=False)
NEW = 6
# every integer counter of ServeStats
COUNTERS = ("new_tokens", "requests", "decode_steps", "preemptions",
            "prefill_tokens_computed", "cached_prefix_tokens",
            "pages_deduped", "cow_copies", "peak_pages_used",
            "prefill_compiles", "host_syncs", "decode_compiles",
            "pages_spilled", "pages_fetched", "prefetch_hits",
            "prefetch_misses", "clean_demotions", "chiplet_promotions",
            "chiplet_demotions", "draft_proposed", "draft_accepted",
            "spec_blocks")
RUNS = {"native": dict(kv_policy="native"),
        "int8": dict(kv_policy="int8"),
        "ngram": dict(kv_policy="native", spec_mode="ngram", spec_k=4)}


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _requests(vocab):
    """Ragged prompts, two sharing a prefix with an earlier one (one
    diverging mid-page), so pages are deduplicated and copied on write."""
    rng = np.random.default_rng(11)
    doc = rng.integers(1, vocab, size=12).tolist()
    return ([doc[:10]]
            + [rng.integers(1, vocab, size=n).tolist() for n in (5, 13)]
            + [doc[:9] + [99, 98, 97], doc + [7, 7]])


@pytest.fixture(scope="module")
def models():
    cfg = reduced(get_config("llama3.2-1b"), d_model=64, n_layers=2,
                  vocab=128)
    tcfg = treduced(tget("llama3.2-1b"), d_model=64, n_layers=2, vocab=128)
    jp = jlm.init_params(cfg, jax.random.PRNGKey(0),
                         RuntimeOptions(dtype="float32"))
    tp = tm.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    return cfg, tcfg, jp, tp


def _port(models, **kw):
    _, tcfg, _, tp = models
    return ServeEngine(tcfg, tp, tm.RuntimeOptions(dtype="float32"),
                       device="cpu", **KW, **kw)


def _counters(eng) -> dict:
    return {c: getattr(eng.stats, c) for c in COUNTERS}


# --------------------- the chunk's start on the device -------------------- #

@pytest.mark.parametrize("start_form", ["0-d", "(1,)"])
@pytest.mark.parametrize("cache_dtype", ["", "int8"])
def test_prefill_chunk_device_start(models, cache_dtype, start_form):
    """Two chunks of a ragged batch of 2: a 0-d or (1,) int32 start gives
    the int start's logits and pool bitwise, and the reference's chunk
    within MODEL_TOL."""
    cfg, tcfg, jp, tp = models
    B, C, ps, npp = 2, 8, 4, 6
    P = B * npp + 1
    rng = np.random.default_rng(7)
    pt = (rng.permutation(P - 1)[:B * npp].reshape(B, npp) + 1).astype(
        np.int32)
    lens = np.asarray([13, 10], np.int32)
    toks = np.zeros((B, 2 * C), np.int32)
    for b in range(B):
        toks[b, :lens[b]] = rng.integers(1, cfg.vocab, size=lens[b])
    jo = RuntimeOptions(dtype="float32", cache_dtype=cache_dtype)
    to = tlm.RuntimeOptions(dtype="float32", cache_dtype=cache_dtype)
    jc = jlm.init_paged_cache(cfg, P, ps, jo)
    by_int = tlm.init_paged_cache(tcfg, P, ps, to, device="cpu")
    by_dev = tlm.init_paged_cache(tcfg, P, ps, to, device="cpu")
    for ci, start in enumerate((0, C)):
        nv = np.minimum(lens, start + C).astype(np.int32)
        cal = ci == 0 and cache_dtype == "int8"
        args = (_t(toks[:, start:start + C]),)
        want, by_int = tlm.prefill_paged_chunk(
            tcfg, tp, *args, by_int, _t(pt), start, _t(nv), to,
            calibrate=cal)
        dstart = torch.tensor(start if start_form == "0-d" else [start],
                              dtype=torch.int32)
        got, by_dev = tlm.prefill_paged_chunk(
            tcfg, tp, *args, by_dev, _t(pt), dstart, _t(nv), to,
            calibrate=cal)
        assert torch.equal(got, want)
        jl, jc = jlm.prefill_paged_chunk(
            cfg, jp, jnp.asarray(toks[:, start:start + C]), jc,
            jnp.asarray(pt), jnp.int32(start), jnp.asarray(nv), jo,
            calibrate=cal)
        np.testing.assert_allclose(got.numpy(), np.asarray(jl), **MODEL_TOL)
    for name, arr in jc["stack"].items():
        assert torch.equal(by_dev["stack"][name], by_int["stack"][name])
        if arr.dtype == jnp.int8:
            np.testing.assert_array_equal(by_dev["stack"][name].numpy(),
                                          np.asarray(arr), err_msg=name)
        else:
            np.testing.assert_allclose(by_dev["stack"][name].numpy(),
                                       np.asarray(arr), **MODEL_TOL,
                                       err_msg=name)


def test_reset_paged_cache_gives_a_fresh_pool(models):
    _, tcfg, _, _ = models
    to = tlm.RuntimeOptions(dtype="float32", cache_dtype="int8")
    pool = tlm.init_paged_cache(tcfg, 5, 4, to, device="cpu")
    fresh = {n: t.clone() for n, t in pool["stack"].items()}
    ptrs = {n: t.data_ptr() for n, t in pool["stack"].items()}
    for t in pool["stack"].values():
        t.fill_(3)
    tm.reset_paged_cache(pool)
    for n, t in pool["stack"].items():
        assert torch.equal(t, fresh[n]) and t.data_ptr() == ptrs[n], n


# ------------------- two serves on one engine, pool reset ----------------- #

@pytest.fixture(scope="module")
def reference(models):
    """The reference engine serving the requests twice, per run: tokens
    and counters after each serve."""
    cfg, _, jp, _ = models
    out = {}
    for run, kw in RUNS.items():
        eng = JaxEngine(cfg, jp, RuntimeOptions(dtype="float32"), **KW, **kw)
        out[run] = [(eng.serve([r[:] for r in _requests(cfg.vocab)], NEW),
                     _counters(eng)) for _ in range(2)]
    return out


@pytest.mark.parametrize("run", list(RUNS))
def test_two_serves_on_one_engine(models, reference, run):
    """The second serve on one engine (the pool allocated once and reset in
    place) equals a fresh engine's serve and the reference engine's second
    serve, in tokens and every counter."""
    reqs = _requests(models[0].vocab)
    eng = _port(models, **RUNS[run])
    pool = None
    for i, (want, want_counts) in enumerate(reference[run]):
        got = eng.serve([r[:] for r in reqs], NEW)
        assert got == want, i
        assert _counters(eng) == want_counts, i
        assert eng.trace_report["ok"] and eng.kv_manager.n_used == 0
        ptr = eng._pool["stack"]["k"].data_ptr()
        assert pool in (None, ptr)
        pool = ptr
    fresh = _port(models, **RUNS[run])
    assert fresh.serve([r[:] for r in reqs], NEW) == got


# ------------------------ the runner's bookkeeping ----------------------- #

def _zero_counts():
    for fn in entries().values():
        fn.launches = 0
        fn.launches_by_heads.clear()
    tcm.attention.calls = 0


class RecordingGraph:
    """A stand-in for the CUDA graph whose capture records and does not
    execute: ``capture(fn)`` runs ``fn`` with ``recording`` set, and the
    block under test then only moves the host counters and returns its
    output buffers; ``replay()`` runs the recorded device work."""
    made = 0
    recording = False

    def __init__(self):
        RecordingGraph.made += 1
        self.replays = 0

    def capture(self, fn):
        RecordingGraph.recording = True
        try:
            self.out, self.work = fn()
        finally:
            RecordingGraph.recording = False
        return self.out

    def replay(self):
        self.replays += 1
        self.work()


def _block(pool):
    """A block over ``pool``: it 'launches' the paged decode twice over 4
    KV heads and the masked attention once, writes 2x into pool[idx] and
    returns x + 1. Under capture it returns its output and its device work
    without doing it; eagerly it does it and returns the output."""
    pd = entries()["paged_decode_attention"]

    def fn(x, idx):
        pd.launches += 2
        pd.launches_by_heads[4] += 2
        tcm.attention.calls += 1
        out = torch.empty_like(x)

        def work():
            pool[idx.long()] = 2 * x
            out.copy_(x + 1)
        if RecordingGraph.recording:
            return out, work
        work()
        return out
    return fn


def test_runner_bookkeeping():
    _zero_counts()
    RecordingGraph.made = 0
    pool = torch.zeros(8)
    runner = BlockGraphs("cpu", new_graph=RecordingGraph)
    fn = _block(pool)
    pd = entries()["paged_decode_attention"]

    # the first call runs eagerly; nothing is captured until asked
    out = runner.run("k", fn, x=np.asarray([1., 2.], np.float32),
                     idx=np.asarray([0, 1], np.int32))
    assert out.tolist() == [2., 3.] and pool[:2].tolist() == [2., 4.]
    assert RecordingGraph.made == 0 and runner.captures == 0
    with pytest.raises(RuntimeError, match="capture_pending"):
        runner.run("other", fn, x=np.zeros(2, np.float32),
                   idx=np.zeros(2, np.int32))
    runner.capture_pending()
    runner.capture_pending()             # nothing pending: no-op
    assert RecordingGraph.made == 1 and runner.captures == 1
    # the capture wrote nothing and left the counters at one run's
    assert pool[:2].tolist() == [2., 4.]
    assert (pd.launches, pd.launches_by_heads[4], tcm.attention.calls) == (
        2, 2, 1)

    block = runner._blocks["k"]
    bufs = {n: (t, t.data_ptr()) for n, t in block.inputs.items()}
    for n in range(1, 4):
        x = np.asarray([10. * n, 20. * n], np.float32)
        got = runner.run("k", fn, x=x, idx=np.asarray([2, 3], np.int32))
        # a later call's inputs reach the replay through the buffers
        assert got is block.outputs and got.tolist() == (x + 1).tolist()
        assert pool[2:4].tolist() == (2 * x).tolist()
        assert (pd.launches, pd.launches_by_heads[4],
                tcm.attention.calls) == (2 * (n + 1), 2 * (n + 1), n + 1)
    assert block.graph.replays == 3 and RecordingGraph.made == 1
    assert all(block.inputs[n] is t and t.data_ptr() == p
               for n, (t, p) in bufs.items())

    # exact after the counters are zeroed between calls
    _zero_counts()
    for _ in range(2):
        runner.run("k", fn, x=np.zeros(2, np.float32),
                   idx=np.zeros(2, np.int32))
    assert (pd.launches, dict(pd.launches_by_heads),
            tcm.attention.calls) == (4, {4: 4}, 2)

    # a second key: one more capture; a key's shapes are fixed
    runner.run("k2", fn, x=np.ones(3, np.float32),
               idx=np.asarray([5, 6, 7], np.int32))
    runner.capture_pending()
    assert runner.captures == 2 == len(runner)
    with pytest.raises(ValueError, match="captured as"):
        runner.run("k2", fn, x=np.ones(2, np.float32),
                   idx=np.zeros(2, np.int32))
    runner.clear()
    assert len(runner) == 0
    _zero_counts()


class RerunGraph:
    """A stand-in for the CUDA graph that runs the block at capture and
    again on replay (its host counters put back, as a replay runs no host
    code), writing the results into the captured outputs. A block's pool
    writes depend only on its inputs, so running it twice is harmless;
    what the stand-in shows is that the engine hands each call's inputs to
    the replay through the key's buffers and reads the graph's outputs."""
    replays = 0

    def capture(self, fn):
        self.fn = fn
        self.out = fn()
        return self.out

    def replay(self):
        RerunGraph.replays += 1
        from repro_torch.serving import graphs
        saved = graphs._counts()
        new = self.fn()
        graphs._set_counts(saved)
        self.out.copy_(new)


SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.9, sample_seed=3)


@pytest.mark.parametrize("run", ["native", "int8", "ngram", "sampled",
                                 "ngram-sampled"])
def test_engine_through_the_runner(models, run):
    """The continuous engine served through the runner (the stand-in
    above) twice: tokens and counters equal to the eager engine's, one
    capture a compiled shape, none on the second serve."""
    kw = dict(RUNS.get(run.removesuffix("-sampled"), {}))
    if run.endswith("sampled"):
        kw.update(SAMPLED)
    reqs = _requests(models[0].vocab)
    eager = _port(models, **kw)
    eng = _port(models, **kw)
    assert eng.graphs is None            # eager on the CPU by default
    eng.graphs = BlockGraphs("cpu", new_graph=RerunGraph)
    RerunGraph.replays = 0
    for i in range(2):
        want = eager.serve([r[:] for r in reqs], NEW)
        got = eng.serve([r[:] for r in reqs], NEW)
        assert got == want, i
        assert _counters(eng) == _counters(eager), i
        assert eng.trace_report["ok"] and eng.kv_manager.n_used == 0
        assert eng.graphs.captures == (eng.stats.decode_compiles
                                       + eng.stats.prefill_compiles)
        if i == 0:
            first = eng.graphs.captures
    assert eng.graphs.captures == first and RerunGraph.replays > 0
    # new weights drop the graphs
    eng.params = eng.params
    assert len(eng.graphs) == 0


# ---------------------------- the graphs option --------------------------- #

# RuntimeOptions whose blocks sync or communicate, so cannot be captured
UNCAPTURABLE = {"ragged": dict(moe_impl="ragged"),
                "shard_map": dict(moe_impl="shard_map"),
                "residual_sharding": dict(residual_sharding=object()),
                "zero3_gather": dict(zero3_gather=(("w", None),)),
                "seq_shard": dict(seq_shard_attn=True,
                                  seq_shard_mesh=object())}


@pytest.mark.parametrize("kw", [dict(device="cpu"),
                                dict(device="cpu", shards=2),
                                dict(device="cuda", shards=2),
                                dict(device="cuda", scheduler="static",
                                     opts=dict(moe_impl="ragged"))]
                         + [dict(device="cuda", opts=o)
                            for o in UNCAPTURABLE.values()])
def test_graphs_true_refused_before_weights(models, monkeypatch, kw):
    """``graphs=True`` needs the card, one shard, the capacity MoE
    dispatch and no sharding in the options, on either engine; it is
    refused before weights are drawn or ranks spawned."""
    def never(*a, **k):
        raise AssertionError("reached past the graphs check")
    monkeypatch.setattr(tengine, "init_params", never)
    monkeypatch.setattr(ksh.ShardGroup, "from_world", never)
    _, tcfg, _, _ = models
    args = dict(scheduler="continuous", graphs=True)
    args.update(kw)
    if "opts" in args:
        args["opts"] = tm.RuntimeOptions(dtype="float32", **args["opts"])
    with pytest.raises(ValueError, match="graphs=True"):
        ServeEngine(tcfg, None, **args)


@pytest.mark.parametrize("opts", ["capacity", "static"]
                         + list(UNCAPTURABLE))
def test_graphs_default_on_the_card(models, monkeypatch, opts):
    """``graphs=None`` on a CUDA device captures with the default options,
    on the continuous and on the static engine ("static"), and serves
    eagerly with options whose blocks cannot be captured (the device is
    resolved to the CPU here, so the engine can be built)."""
    monkeypatch.setattr(tengine, "resolve_device",
                        lambda device: torch.device("cpu"))
    monkeypatch.setattr(tengine, "kernel_width_reason", lambda *a: "")
    _, tcfg, _, tp = models
    o = tm.RuntimeOptions(dtype="float32", **UNCAPTURABLE.get(opts, {}))
    kw = dict(KW, scheduler="static") if opts == "static" else KW
    eng = ServeEngine(tcfg, tp, o, device="cuda", **kw)
    captured = opts in ("capacity", "static")
    assert (eng.graphs is None) == (eng.static_graphs is None) == (
        not captured)


def test_graphs_default(models):
    assert _port(models).graphs is None
    assert _port(models, graphs=False).graphs is None
    counts = collections.Counter(entries())
    assert set(counts) == {"paged_decode_attention",
                           "chunk_prefill_attention",
                           "spec_verify_attention", "decode_attention",
                           "flash_attention"}
