"""The port's continuous engine (repro_torch.serving.ServeEngine) against
the reference engine (repro.serving.ServeEngine, attn_impl="xla") on the
same weights and requests, on the CPU.

Token identity and equal bookkeeping (host syncs, prefill tokens, COW
copies, peak pages) over {native, int8} x prefix cache {on, off} at K=8,
the port's K=1 == K=8 identity, trace reconciliation, and the
entry-point contract (CUDA by default, options and attention masks the
port does not run yet rejected)."""
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
from repro_torch.serving import ServeEngine

torch.set_num_threads(2)

# the settings of the reference's own K-identity engine test
KW = dict(max_len=40, scheduler="continuous", page_size=4, max_batch=4,
          prefill_chunk=8, decode_lookahead=8)
NEW = 6
COUNTERS = ("host_syncs", "prefill_tokens_computed", "cow_copies",
            "peak_pages_used", "cached_prefix_tokens", "decode_steps",
            "preemptions", "new_tokens")
MATRIX = [("native", True), ("native", False), ("int8", True),
          ("int8", False)]


def _requests(vocab):
    """Six ragged prompts; two share a 10-token prefix with a finished
    request and one diverges from it mid-page, so the prefix cache dedups
    pages and copies one on write (page_size 4)."""
    rng = np.random.default_rng(11)
    doc = rng.integers(1, vocab, size=12).tolist()
    return ([doc[:10]]
            + [rng.integers(1, vocab, size=n).tolist() for n in (5, 13, 8)]
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


@pytest.fixture(scope="module")
def reference(models):
    """The reference engine's outputs and counters, once per cell. Both
    engines run with overlap=False: with two overlapped virtual streams the
    composition of a decode block depends on measured wall times, which
    differ between the two packages; serialized, it is deterministic."""
    cfg, _, jp, _ = models
    runs = {}
    for pol, pc in MATRIX:
        eng = JaxEngine(cfg, jp, RuntimeOptions(dtype="float32"), **KW,
                        kv_policy=pol, prefix_cache=pc, overlap=False)
        outs = eng.serve([r[:] for r in _requests(cfg.vocab)], NEW)
        runs[pol, pc] = (outs, {c: getattr(eng.stats, c) for c in COUNTERS})
    return runs


def _port(models, **kw):
    _, tcfg, _, tp = models
    args = dict(KW, device="cpu", overlap=False)
    args.update(kw)
    return ServeEngine(tcfg, tp, tm.RuntimeOptions(dtype="float32"), **args)


def _tie_free_prefix(models, prompt, out, gap=1e-4):
    """Length of ``out`` before the first position where the reference's
    f32 logits have a top-2 gap below ``gap`` (where argmax may
    legitimately flip between two correct implementations)."""
    cfg, _, jp, _ = models
    seq = jnp.asarray([prompt + out], jnp.int32)
    logits, _ = jlm.forward(cfg, jp, seq, RuntimeOptions(dtype="float32"))
    lg = np.asarray(logits[0, len(prompt) - 1:len(prompt) - 1 + len(out)])
    top2 = np.sort(lg, axis=-1)[:, -2:]
    near = np.flatnonzero(top2[:, 1] - top2[:, 0] < gap)
    return int(near[0]) if near.size else len(out)


def _assert_token_identical(models, got, want):
    reqs = _requests(models[0].vocab)
    for prompt, g, w in zip(reqs, got, want):
        if g != w:
            n = _tie_free_prefix(models, prompt, w)
            assert n < len(w) and g[:n] == w[:n], (g, w)


@pytest.mark.parametrize("kv_policy,prefix_cache", MATRIX)
def test_engine_matches_reference(models, reference, kv_policy,
                                  prefix_cache):
    want, want_stats = reference[kv_policy, prefix_cache]
    eng = _port(models, kv_policy=kv_policy, prefix_cache=prefix_cache)
    got = eng.serve([r[:] for r in _requests(models[0].vocab)], NEW)
    _assert_token_identical(models, got, want)
    assert {c: getattr(eng.stats, c) for c in COUNTERS} == want_stats
    assert eng.trace_report["ok"]
    assert eng.kv_manager.n_used == 0
    if prefix_cache:
        assert eng.stats.cow_copies >= 1 and eng.stats.pages_deduped >= 1


@pytest.mark.parametrize("kv_policy", ["native", "int8"])
def test_engine_lookahead_identity(models, kv_policy):
    """K=1 (one host pull per token) and K=8 emit the same tokens, with
    the default overlapped streams."""
    reqs = _requests(models[0].vocab)
    outs = {}
    for k in (1, 8):
        eng = _port(models, kv_policy=kv_policy, decode_lookahead=k,
                    overlap=True)
        outs[k] = eng.serve([r[:] for r in reqs], NEW)
        assert eng.trace_report["ok"] and eng.kv_manager.n_used == 0
    assert outs[1] == outs[8]


def test_engine_eos_and_sync_bound(models):
    """EOS mid-block retires the request with the K=1 output, and a
    T-token request takes at most ceil(T/K) + 2 host syncs."""
    reqs = _requests(models[0].vocab)[:2]
    base = _port(models, decode_lookahead=1).serve([r[:] for r in reqs], 10)
    eos = base[0][4]
    outs = {k: _port(models, decode_lookahead=k, eos_id=eos, max_len=48)
            .serve([r[:] for r in reqs], 10) for k in (1, 8)}
    assert outs[1] == outs[8]
    assert outs[8][0][-1] == eos and len(outs[8][0]) <= 10
    one = _port(models, decode_lookahead=8, max_batch=1, max_len=48)
    one.serve([reqs[0][:]], 17)
    chunks = -(-len(reqs[0]) // KW["prefill_chunk"])
    assert one.stats.host_syncs <= chunks + 1 + -(-16 // 8)


def test_second_serve_reconciles(models):
    eng = _port(models)
    reqs = _requests(models[0].vocab)
    a = eng.serve([r[:] for r in reqs], NEW)
    b = eng.serve([r[:] for r in reqs], NEW)
    assert a == b and eng.trace_report["ok"]
    assert eng.stats.requests == 2 * len(reqs)


# ------------------------------ contract -------------------------------- #

def test_default_device_needs_cuda(models):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    _, tcfg, _, tp = models
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(tcfg, tp)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(tcfg)


@pytest.mark.parametrize("arch,kw,item", [
    # the static engine serves both; the paged path refuses them, as the
    # reference's does
    ("gemma3-1b", dict(scheduler="continuous"), "windowed page masking"),
    ("paligemma-3b", dict(scheduler="continuous"),
     "family 'vlm' is not covered by the paged KV path"),
    # head sharding runs on the continuous engine only, with the
    # reference's ValueError
    (None, dict(scheduler="static", shards=2), "continuous"),
])
def test_off_path_options_raise(models, arch, kw, item):
    _, tcfg, _, tp = models
    if arch is not None:
        tcfg, tp = treduced(tget(arch)), None
    exc = ValueError if "shards" in kw else NotImplementedError
    with pytest.raises(exc, match=item):
        ServeEngine(tcfg, tp, device="cpu", **kw)


def test_off_path_families_raise():
    # arctic-480b (MoE) is served since the MoE FFN was ported; MLA and
    # Mamba-2 run on the static engine, and the continuous engine refuses
    # them with the reference's paged_supported reasons
    for arch, reason in (("deepseek-v2-236b", "MLA latent cache is already "
                          "compressed"),
                         ("mamba2-130m", "family 'ssm' has no paged serving "
                          "path")):
        cfg = treduced(tget(arch))
        assert tm.static_supported(cfg) is None
        with pytest.raises(NotImplementedError, match=reason):
            ServeEngine(cfg, device="cpu")
        ServeEngine(cfg, device="cpu", scheduler="static")
