"""Head width 256 in the port's paged decode, chunk, verify and flash
kernels, on the CPU.

(a) The plain versions of the four entries at dh 256 against the
reference's Pallas kernels in interpret mode, on inputs made with numpy
from a seed: paligemma-3b's group 8 and gemma3-1b's group 4 over one KV
head, f32 and bf16 queries over their own pool and over int8, ragged
lengths over shuffled tables; and the split mirrors of the paged decode
and the chunk kernel (``_paged_split_plain``, ``_chunk_split_plain``:
pass 1's partials and the fixed-order combine) at the splits the kernels
take (``paged_split``, ``chunk_split``, which read shapes only and keep
their rules at 256) and on split edges.

(b) paligemma-3b's Gemma-2B decoder served text-only (``family="dense"``,
no image prefix: the one derivation of a config file that the paged path
and flash reach at head width 256), its reduced twin with ``head_dim``
set back to 256, on the port's continuous engine (chunked prefill, int8,
n-gram speculation) and static engine against the JAX engines in f32:
equal tokens and equal ``ServeStats`` counters.

That ``kernel_width_reason`` takes the full-width derived decoder on
every path is tests/test_torch_kernel_widths.py's. The CUDA kernels themselves are held against the plain versions on the
card by tests/test_torch_kernels_cuda.py and chip_smoke.py."""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.decode_attention as da
import repro.kernels.flash_attention as fa
import repro_torch.kernels.decode_attention as tk
import repro_torch.models as tm
from repro.configs import get_config
from repro.configs.reduce import reduced
from repro.models import RuntimeOptions
from repro.models import lm as jlm
from repro.serving import ServeEngine as JaxEngine
from repro_torch.configs import get_config as tget
from repro_torch.configs.reduce import reduced as treduced
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.serving import ServeEngine
from torch_kernel_inputs import PALI_TEXT, chunk_edges, split_edges
from torch_kernel_inputs import pool as _pool
from torch_kernel_inputs import quantize as _quantize
from torch_kernel_inputs import t as _t
from torch_kernel_inputs import tables as _tables
from torch_kernel_inputs import verify_window as _verify_window

torch.set_num_threads(2)

DH, HKV, PS, NPP, C = 256, 1, 32, 3, 8
L = NPP * PS
# f32 to f32 sums in another order; bf16 to one bf16 rounding of the output
TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}
GROUPS = [8, 4]                 # paligemma-3b's and gemma3-1b's


def _j(a, dtype="float32"):
    x = jnp.asarray(a)
    return x.astype(jnp.bfloat16) if dtype == "bfloat16" else x


def _tt(a, dtype="float32"):
    x = _t(a)
    return x.to(torch.bfloat16) if dtype == "bfloat16" else x


def _paged(seed, B, group, C_, quant, dtype):
    """Queries (B, C_, H, dh) (C_ = 0: decode, (B, H, dh)), shuffled
    tables, pools in the query's dtype or int8 with scales; the same
    values for both packages."""
    rng = np.random.default_rng(seed)
    P = B * NPP + 1
    kp, vp = _pool(rng, P, PS, HKV, DH)
    pt = _tables(rng, B, NPP, P)
    shape = (B, C_, HKV * group, DH) if C_ else (B, HKV * group, DH)
    q = rng.standard_normal(shape, dtype=np.float32)
    sc = {}
    if quant:
        kp, ksc = _quantize(kp)
        vp, vsc = _quantize(vp)
        sc = dict(k_scale=ksc, v_scale=vsc)
    pdt = "int8" if quant else dtype
    jax_in = dict(q=_j(q, dtype), kp=_j(kp, pdt), vp=_j(vp, pdt), pt=_j(pt),
                  sc={k: _j(v) for k, v in sc.items()})
    torch_in = dict(q=_tt(q, dtype), kp=_tt(kp, pdt), vp=_tt(vp, pdt),
                    pt=_t(pt), sc={k: _t(v) for k, v in sc.items()})
    return jax_in, torch_in


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **TOL[dtype])


# (group, dtype, int8 pool): each group, each query dtype, each pool kind
CASES = [(8, "float32", False), (8, "bfloat16", True), (4, "bfloat16", False),
         (4, "float32", True)]


def _past(m, split, frontier):
    """Where a split starts at or past its row's frontier (frontier: m's
    shape without the split axis)."""
    return (torch.arange(m.shape[-1]) * split
            >= frontier[..., None].long()).expand_as(m)


# --------------------------- (a) the kernels ---------------------------- #

@pytest.mark.parametrize("group,dtype,quant", CASES)
def test_paged_decode_matches_pallas(group, dtype, quant):
    """seq_lens at 1, the full table and each edge +-1 of whole-page
    splits: the plain version and the split mirror (at those splits and at
    the one the kernel takes for this shape) equal the Pallas kernel; a
    split wholly past seq_lens contributes m = NEG_INF, l = 0, acc = 0."""
    lens = np.asarray(sorted(set().union(
        *(split_edges(L, s) for s in (PS, 2 * PS)))), np.int32)
    B = len(lens)
    j, t = _paged(group, B, group, 0, quant, dtype)
    want = da.paged_decode_attention(j["q"], j["kp"], j["vp"], j["pt"],
                                     _j(lens), interpret=True, **j["sc"])
    got = tk.paged_decode_attention(t["q"], t["kp"], t["vp"], t["pt"],
                                    _t(lens), **t["sc"])
    assert got.dtype == t["q"].dtype and got.shape == t["q"].shape
    _close(got, want, dtype)
    kernel_split = tk.paged_split(B, HKV, L, group, PS, 132)
    for split in sorted({PS, 2 * PS, L, kernel_split}):
        mirror, (m, l, acc) = tk._paged_split_plain(
            t["q"], t["kp"], t["vp"], t["pt"], _t(lens), split, **t["sc"])
        _close(mirror, want, dtype)
        past = _past(m, split, _t(lens)[:, None].expand(m.shape[:2]))
        assert bool((m[past] == tk.NEG_INF).all())
        assert bool((l[past] == 0).all()) and bool((acc[past] == 0).all())


@pytest.mark.parametrize("group,dtype,quant", CASES)
def test_chunk_prefill_matches_pallas(group, dtype, quant):
    """Chunks at 0 and with frontiers on and beside a page edge, the last
    two right-padded (n_valid < start + C): the plain version and the
    split mirror at whole stages and at the kernel's split."""
    start, nv = chunk_edges(PS, C, L)
    B = len(start)
    j, t = _paged(10 + group, B, group, C, quant, dtype)
    want = da.chunk_prefill_attention(j["q"], j["kp"], j["vp"], j["pt"],
                                      _j(start), _j(nv), interpret=True,
                                      **j["sc"])
    got = tk.chunk_prefill_attention(t["q"], t["kp"], t["vp"], t["pt"],
                                     _t(start), _t(nv), **t["sc"])
    _close(got, want, dtype)
    frontier = torch.minimum(_t(start)[:, None] + torch.arange(C) + 1,
                             _t(nv)[:, None])                    # (B, C)
    kernel_split = tk.chunk_split(B, HKV, C, group, L, 132, DH)
    for split in sorted({PS, 2 * PS, kernel_split}):
        mirror, (m, l, acc) = tk._chunk_split_plain(
            t["q"], t["kp"], t["vp"], t["pt"], _t(start), _t(nv), split,
            **t["sc"])
        assert m.shape == (*t["q"].shape[:3], -(-L // split))
        _close(mirror, want, dtype)
        past = _past(m, split, frontier[:, :, None].expand(m.shape[:3]))
        assert bool((m[past] == tk.NEG_INF).all())
        assert bool((l[past] == 0).all()) and bool((acc[past] == 0).all())


@pytest.mark.parametrize("group,dtype,quant", CASES[1:3])
def test_spec_verify_matches_pallas(group, dtype, quant):
    """A C=5 window: ragged fed lengths, an inactive row on a table of
    null pages, a window across a page edge."""
    rng = np.random.default_rng(20 + group)
    B, Cw = 4, 5
    seq_lens, n_fed = _verify_window(rng, B, Cw, NPP, PS)
    seq_lens[1], n_fed[1] = PS - 2, Cw
    j, t = _paged(20 + group, B, group, Cw, quant, dtype)
    j["pt"] = j["pt"].at[0].set(0)
    t["pt"][0] = 0
    want = da.spec_verify_attention(j["q"], j["kp"], j["vp"], j["pt"],
                                    _j(seq_lens), _j(n_fed), interpret=True,
                                    **j["sc"])
    got = tk.spec_verify_attention(t["q"], t["kp"], t["vp"], t["pt"],
                                   _t(seq_lens), _t(n_fed), **t["sc"])
    _close(got, want, dtype)


@pytest.mark.parametrize("group,dtype,causal", [(8, "bfloat16", True),
                                                (8, "float32", False),
                                                (4, "float32", True)])
def test_flash_matches_pallas(group, dtype, causal):
    rng = np.random.default_rng(30 + group)
    B, S = 1, 128
    q, k, v = (rng.standard_normal((B, S, h, DH), dtype=np.float32)
               for h in (HKV * group, HKV, HKV))
    want = fa.flash_attention(_j(q, dtype), _j(k, dtype), _j(v, dtype),
                              causal=causal, interpret=True, block_q=64,
                              block_kv=64)
    got = flash_attention_plain(_tt(q, dtype), _tt(k, dtype), _tt(v, dtype),
                                causal=causal)
    assert got.dtype == _tt(q, dtype).dtype
    _close(got, want, dtype)


def test_split_rules_keep_their_shape_at_256():
    """The split rules read shapes and the SM count only: the kernels keep
    their rows a block and keys a step at 256, where the chunk's rule
    (which takes the head width for the stages above 256) gives what it
    gives at 128. At paligemma-3b's continuous shapes (B=8 slots, 1 KV
    head, group 8; a 576-key table of 16-key pages) the paged decode's
    128-key cap and the chunk's four stages set the splits."""
    assert list(inspect.signature(tk.paged_split).parameters) == [
        "B", "Hkv", "n_keys", "group", "page_size", "n_sm"]
    assert list(inspect.signature(tk.chunk_split).parameters) == [
        "B", "Hkv", "C", "group", "n_keys", "n_sm", "dh"]
    assert tk.paged_split(8, 1, 576, 8, 16, 132) == 48
    for shape in ((1, 1, 64, 8, 576, 132), (8, 1, 5, 8, 576, 132)):
        assert tk.chunk_split(*shape, 256) == tk.chunk_split(*shape, 128)
    assert tk.chunk_split(1, 1, 64, 8, 576, 132, 256) == 32
    assert tk.chunk_split(8, 1, 5, 8, 576, 132, 256) == 32
    assert 256 in tk._HEAD_DIMS


# ---------------------------- (b) the engines --------------------------- #

@pytest.fixture(scope="module")
def model():
    """The derived decoder's reduced twin (2 layers, d_model 64) at
    paligemma-3b's attention width: 8 query heads over 1 KV head at head
    width 256; the reference's f32 weights in both packages."""
    kw = dict(n_heads=8, n_kv_heads=1, head_dim=DH, **PALI_TEXT)
    cfg = reduced(get_config("paligemma-3b"), d_model=64, n_layers=2,
                  vocab=128).replace(**kw)
    tcfg = treduced(tget("paligemma-3b"), d_model=64, n_layers=2,
                    vocab=128).replace(**kw)
    jp = jlm.init_params(cfg, jax.random.PRNGKey(0),
                         RuntimeOptions(dtype="float32"))
    tp = tm.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    return cfg, tcfg, jp, tp


KW = dict(max_len=40, scheduler="continuous", page_size=4, max_batch=4,
          prefill_chunk=8, decode_lookahead=8, overlap=False)
COUNTERS = ("host_syncs", "prefill_tokens_computed", "cow_copies",
            "peak_pages_used", "cached_prefix_tokens", "decode_steps",
            "decode_compiles", "preemptions", "new_tokens", "spec_blocks",
            "draft_proposed", "draft_accepted")
STATIC_COUNTERS = ("host_syncs", "decode_steps", "decode_compiles",
                   "new_tokens", "requests")


def _requests(vocab):
    """Five ragged prompts; two share a prefix with a finished request
    (page 4: pages deduped, one copied on write), one repeats itself (the
    n-gram drafter finds matches)."""
    rng = np.random.default_rng(11)
    doc = rng.integers(1, vocab, size=12).tolist()
    return ([doc[:10]] + [rng.integers(1, vocab, size=n).tolist()
                          for n in (5, 13)]
            + [doc[:9] + [99, 98, 97], doc[:6] * 2])


def _stats(eng, names):
    return {c: getattr(eng.stats, c) for c in names}


@pytest.mark.parametrize("kv_policy,spec", [("native", "off"),
                                            ("int8", "ngram")])
def test_continuous_engine_matches_reference(model, kv_policy, spec):
    cfg, tcfg, jp, tp = model
    kw = dict(KW, kv_policy=kv_policy, spec_mode=spec, spec_k=4)
    reqs = _requests(cfg.vocab)
    ref = JaxEngine(cfg, jp, RuntimeOptions(dtype="float32"), **kw)
    want = ref.serve([r[:] for r in reqs], 6)
    eng = ServeEngine(tcfg, tp, tm.RuntimeOptions(dtype="float32"),
                      device="cpu", **kw)
    assert eng.serve([r[:] for r in reqs], 6) == want
    assert _stats(eng, COUNTERS) == _stats(ref, COUNTERS)
    assert eng.trace_report["ok"] and eng.kv_manager.n_used == 0
    assert eng.stats.cow_copies >= 1 and eng.stats.new_tokens == 30
    if spec == "ngram":
        assert eng.stats.spec_blocks > 0


def test_static_engine_matches_reference(model):
    """serve_bucketed (a wave a length bucket) and generate on one wave
    (flash's and the dense decode's plain versions at dh 256; the int8
    cache is the continuous engine's case above)."""
    cfg, tcfg, jp, tp = model
    kw = dict(max_len=40, decode_lookahead=8)
    rng = np.random.default_rng(3)
    reqs = [rng.integers(1, cfg.vocab, size=n).tolist() for n in (5, 9, 5)]
    ref = JaxEngine(cfg, jp, RuntimeOptions(dtype="float32"), **kw)
    eng = ServeEngine(tcfg, tp, tm.RuntimeOptions(dtype="float32"),
                      device="cpu", scheduler="static", **kw)
    assert eng.serve([r[:] for r in reqs], 7) == ref.serve(
        [r[:] for r in reqs], 7)
    assert _stats(eng, STATIC_COUNTERS) == _stats(ref, STATIC_COUNTERS)
    wave = np.asarray([reqs[0], reqs[2]])
    assert eng.generate(wave, 7) == ref.generate(wave, 7)
    assert _stats(eng, STATIC_COUNTERS) == _stats(ref, STATIC_COUNTERS)
