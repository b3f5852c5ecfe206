"""Head widths 384 and 512 in the port's five kernel entries, on the CPU.

(a) The plain versions of the paged decode, chunk prefill, spec verify,
dense decode and flash entries at dh 384 and 512 against the reference's
Pallas kernels in interpret mode, on inputs made with numpy from a seed:
groups 8 and 4 over one KV head, f32 and bf16 queries over their own pool
and over int8, ragged lengths over shuffled tables.

(b) The split mirrors of the paged decode, the chunk kernel and the dense
decode (``_paged_split_plain``, ``_chunk_split_plain``,
``_decode_split_plain``: pass 1's partials and the fixed-order combine)
at the splits the kernels take at these widths (``paged_split``,
``chunk_split`` with its head width, ``decode_split``) and on and beside
their edges. Tolerances: 1e-5 in f32 (sums in another order), 2e-2 in
bf16 (one rounding of the output).

(c) The dh-512 text decoder (paligemma-3b's Gemma-2B decoder, text-only,
its 8 heads of 256 regrouped as 4 of 512 over its 1 KV head) as a reduced
twin with ``head_dim`` set back to 512 at 2 layers, on the port's
continuous engine (chunked prefill, int8, n-gram speculation) and static
engine against the JAX engines in f32: equal tokens and equal
``ServeStats`` counters; the same twin at 384 on the continuous engine.

That ``kernel_width_reason`` takes 384 and 512 on every path and refuses
640 is tests/test_torch_kernel_widths.py's. The CUDA kernels themselves are
held against the plain versions on the card by
tests/test_torch_kernels_cuda.py and chip_smoke.py."""
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
from torch_kernel_inputs import WIDE_TEXT, chunk_edges, split_edges
from torch_kernel_inputs import pool as _pool
from torch_kernel_inputs import quantize as _quantize
from torch_kernel_inputs import t as _t
from torch_kernel_inputs import tables as _tables
from torch_kernel_inputs import verify_window as _verify_window

torch.set_num_threads(2)

HKV, PS, NPP, C = 1, 32, 3, 8
L = NPP * PS
DHS = [384, 512]
# f32 to f32 sums in another order; bf16 to one bf16 rounding of the output
TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}
# (group, dtype, int8 pool): each group, each query dtype, each pool kind
CASES = [(8, "float32", False), (8, "bfloat16", True), (4, "bfloat16", False),
         (4, "float32", True)]


def _j(a, dtype="float32"):
    x = jnp.asarray(a)
    return x.astype(jnp.bfloat16) if dtype == "bfloat16" else x


def _tt(a, dtype="float32"):
    x = _t(a)
    return x.to(torch.bfloat16) if dtype == "bfloat16" else x


def _paged(seed, dh, B, group, C_, quant, dtype):
    """Queries (B, C_, H, dh) (C_ = 0: decode, (B, H, dh)), shuffled
    tables, pools in the query's dtype or int8 with scales; the same
    values for both packages."""
    rng = np.random.default_rng(seed)
    P = B * NPP + 1
    kp, vp = _pool(rng, P, PS, HKV, dh)
    pt = _tables(rng, B, NPP, P)
    shape = (B, C_, HKV * group, dh) if C_ else (B, HKV * group, dh)
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


def _past(m, split, frontier):
    """Where a split starts at or past its row's frontier (frontier: m's
    shape without the split axis)."""
    return (torch.arange(m.shape[-1]) * split
            >= frontier[..., None].long()).expand_as(m)


def _empty_past(m, l, acc, split, frontier):
    past = _past(m, split, frontier)
    assert bool((m[past] == tk.NEG_INF).all())
    assert bool((l[past] == 0).all()) and bool((acc[past] == 0).all())


# ------------------------ (a), (b) the kernels -------------------------- #

@pytest.mark.parametrize("dh", DHS)
@pytest.mark.parametrize("group,dtype,quant", CASES)
def test_paged_decode_matches_pallas(dh, group, dtype, quant):
    """seq_lens at 1, the full table and each edge +-1 of whole-page
    splits: the plain version and the split mirror (at those splits and at
    the one the kernel takes for this shape) equal the Pallas kernel; a
    split wholly past seq_lens contributes m = NEG_INF, l = 0, acc = 0."""
    lens = np.asarray(sorted(set().union(
        *(split_edges(L, s) for s in (PS, 2 * PS)))), np.int32)
    B = len(lens)
    j, t = _paged(dh + group, dh, B, group, 0, quant, dtype)
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
        _empty_past(m, l, acc, split, _t(lens)[:, None].expand(m.shape[:2]))


@pytest.mark.parametrize("dh", DHS)
@pytest.mark.parametrize("group,dtype,quant", CASES)
def test_chunk_prefill_matches_pallas(dh, group, dtype, quant):
    """Chunks at 0 and with frontiers on and beside a page edge and the
    kernel's split edge, the last two right-padded (n_valid < start + C):
    the plain version and the split mirror at whole stages and at the
    split the kernel takes at this head width."""
    kernel_split = tk.chunk_split(4, HKV, C, group, L, 132, dh)
    for edge in (PS, kernel_split):
        start, nv = chunk_edges(edge, C, L)
        B = len(start)
        j, t = _paged(10 + dh + group + edge, dh, B, group, C, quant, dtype)
        want = da.chunk_prefill_attention(j["q"], j["kp"], j["vp"], j["pt"],
                                          _j(start), _j(nv), interpret=True,
                                          **j["sc"])
        got = tk.chunk_prefill_attention(t["q"], t["kp"], t["vp"], t["pt"],
                                         _t(start), _t(nv), **t["sc"])
        _close(got, want, dtype)
        frontier = torch.minimum(_t(start)[:, None] + torch.arange(C) + 1,
                                 _t(nv)[:, None])                # (B, C)
        for split in sorted({PS, 2 * PS, kernel_split}):
            mirror, (m, l, acc) = tk._chunk_split_plain(
                t["q"], t["kp"], t["vp"], t["pt"], _t(start), _t(nv), split,
                **t["sc"])
            assert m.shape == (*t["q"].shape[:3], -(-L // split))
            _close(mirror, want, dtype)
            _empty_past(m, l, acc, split,
                        frontier[:, :, None].expand(m.shape[:3]))


@pytest.mark.parametrize("dh", DHS)
@pytest.mark.parametrize("group,dtype,quant", CASES[1:3])
def test_spec_verify_matches_pallas(dh, group, dtype, quant):
    """A C=5 window: ragged fed lengths, an inactive row on a table of
    null pages, windows across a page edge and the kernel's split edge."""
    rng = np.random.default_rng(20 + dh + group)
    B, Cw = 4, 5
    seq_lens, n_fed = _verify_window(rng, B, Cw, NPP, PS)
    edge = tk.chunk_split(B, HKV, Cw, group, L, 132, dh)
    seq_lens[1], n_fed[1] = PS - 2, Cw
    seq_lens[2], n_fed[2] = min(edge, L - Cw) - 1, Cw
    j, t = _paged(20 + dh + group, dh, B, group, Cw, quant, dtype)
    j["pt"] = j["pt"].at[0].set(0)
    t["pt"][0] = 0
    want = da.spec_verify_attention(j["q"], j["kp"], j["vp"], j["pt"],
                                    _j(seq_lens), _j(n_fed), interpret=True,
                                    **j["sc"])
    got = tk.spec_verify_attention(t["q"], t["kp"], t["vp"], t["pt"],
                                   _t(seq_lens), _t(n_fed), **t["sc"])
    _close(got, want, dtype)


@pytest.mark.parametrize("dh", DHS)
@pytest.mark.parametrize("group,dtype,quant", CASES)
def test_dense_decode_matches_pallas(dh, group, dtype, quant):
    """The dense decode over an L=100 cache (no multiple of a split) with
    kv_valid at 1, L and each split edge +-1: the plain version and the
    split mirror at the kernel's split (``decode_split``) and at 16 keys
    equal the Pallas kernel; a split past kv_valid contributes m =
    NEG_INF, l = 0, acc = 0."""
    rng = np.random.default_rng(40 + dh + group)
    Ld = 100
    kernel_split = tk.decode_split(12, HKV, Ld, group, 132)
    valid = np.asarray(sorted(set(split_edges(Ld, kernel_split))
                              | set(split_edges(Ld, 16))), np.int32)
    B = len(valid)
    kc, vc = (rng.standard_normal((B, Ld, HKV, dh), dtype=np.float32)
              for _ in range(2))
    q = rng.standard_normal((B, HKV * group, dh), dtype=np.float32)
    sc = {}
    if quant:
        kc, ksc = _quantize(kc)
        vc, vsc = _quantize(vc)
        sc = dict(k_scale=ksc, v_scale=vsc)
    pdt = "int8" if quant else dtype
    want = da.decode_attention(_j(q, dtype), _j(kc, pdt), _j(vc, pdt),
                               _j(valid), interpret=True,
                               **{k: _j(v) for k, v in sc.items()})
    tq, tkc, tvc = _tt(q, dtype), _tt(kc, pdt), _tt(vc, pdt)
    tsc = {k: _t(v) for k, v in sc.items()}
    got = tk.decode_attention(tq, tkc, tvc, _t(valid), **tsc)
    _close(got, want, dtype)
    for split in sorted({16, kernel_split}):
        mirror, (m, l, acc) = tk._decode_split_plain(
            tq, tkc, tvc, _t(valid), split, **tsc)
        _close(mirror, want, dtype)
        _empty_past(m, l, acc, split, _t(valid)[:, None].expand(m.shape[:2]))


@pytest.mark.parametrize("dh", DHS)
@pytest.mark.parametrize("group,dtype,causal", [(8, "bfloat16", True),
                                                (4, "float32", False),
                                                (4, "bfloat16", True)])
def test_flash_matches_pallas(dh, group, dtype, causal):
    rng = np.random.default_rng(30 + dh + group)
    B, S = 1, 128
    q, k, v = (rng.standard_normal((B, S, h, dh), dtype=np.float32)
               for h in (HKV * group, HKV, HKV))
    want = fa.flash_attention(_j(q, dtype), _j(k, dtype), _j(v, dtype),
                              causal=causal, interpret=True, block_q=64,
                              block_kv=64)
    got = flash_attention_plain(_tt(q, dtype), _tt(k, dtype), _tt(v, dtype),
                                causal=causal)
    assert got.dtype == _tt(q, dtype).dtype
    _close(got, want, dtype)


def test_chunk_split_takes_the_head_width():
    """Above 256 a stage holds 32 keys (two warps share each tile's
    columns; two 64-key stages would not fit at 512): a split is whole
    32-key stages, at most four, covering the table; at 256 and below the
    rule is as before (64-key stages with 16-row tiles)."""
    for dh in (384, 512):
        for B, Hkv, Cc, group, n_keys in ((1, 1, 64, 4, 576),
                                          (8, 1, 5, 4, 576),
                                          (8, 1, 1, 8, 96),
                                          (2, 1, 5, 1, 4096)):
            split = tk.chunk_split(B, Hkv, Cc, group, n_keys, 132, dh)
            n = -(-n_keys // split)
            assert split % 32 == 0 and 32 <= split <= 128
            assert n * split >= n_keys and (n - 1) * split < n_keys
    # 16-row tiles (C * group <= 16): 64-key stages up to 256, 32 above
    assert tk.chunk_split(1, 1, 1, 8, 96, 132, 256) == 64
    assert tk.chunk_split(1, 1, 1, 8, 96, 132, 384) == 32
    assert tk.chunk_split(1, 1, 1, 8, 96, 132, 512) == 32
    # 64-row tiles: 32-key stages at every width
    assert (tk.chunk_split(1, 1, 64, 4, 576, 132, 512)
            == tk.chunk_split(1, 1, 64, 4, 576, 132, 128))
    assert tk._HEAD_DIMS == (64, 128, 256, 384, 512)


# ---------------------------- (c) the engines --------------------------- #

def _twin(dh):
    """The dh-``dh`` text decoder's reduced twin (2 layers, d_model 64) at
    4 query heads over 1 KV head; the reference's f32 weights in both
    packages."""
    kw = dict(WIDE_TEXT, head_dim=dh)
    cfg = reduced(get_config("paligemma-3b"), d_model=64, n_layers=2,
                  vocab=128).replace(**kw)
    tcfg = treduced(tget("paligemma-3b"), d_model=64, n_layers=2,
                    vocab=128).replace(**kw)
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim) == (4, 1, dh)
    jp = jlm.init_params(cfg, jax.random.PRNGKey(0),
                         RuntimeOptions(dtype="float32"))
    tp = tm.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    return cfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def model():
    return _twin(512)


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


def _continuous(twin, kv_policy, spec):
    cfg, tcfg, jp, tp = twin
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


@pytest.mark.parametrize("kv_policy,spec", [("native", "off"),
                                            ("int8", "ngram")])
def test_continuous_engine_matches_reference(model, kv_policy, spec):
    _continuous(model, kv_policy, spec)


def test_static_engine_matches_reference(model):
    """serve_bucketed (a wave a length bucket) and generate on one wave
    (flash's and the dense decode's plain versions at dh 512)."""
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


def test_continuous_engine_at_384_matches_reference():
    _continuous(_twin(384), "native", "off")
