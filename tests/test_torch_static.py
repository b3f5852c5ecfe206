"""The port's static dense-cache path against the reference, on the CPU.

* Kernels: the plain versions of ``decode_attention`` (dense-cache decode)
  and ``flash_attention`` against the Pallas kernels in interpret mode, on
  the same numpy inputs from a seed (f32/bf16, MHA/GQA/MQA, head_dim 64 and
  128, ragged kv_valid, an L that is no block multiple, int8 against the
  int8 oracle, causal and full).
* Model: ``forward(collect_kv)``, ``prefill``, ``decode_step`` and
  ``decode_steps`` against ``repro.models`` (attn_impl="xla") on the
  reduced llama3.2-1b and qwen2.5-3b twins, native and int8, and one
  head_dim-128 case against attn_impl="pallas", whose prefill reaches the
  flash kernel.
* Engine: ``ServeEngine(scheduler="static")`` against the reference's
  static engine (tokens and counters), against the port's continuous
  engine, the sampled per-token loop fed the reference's Gumbel noise,
  and the CLI.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.decode_attention as da
import repro.kernels.flash_attention as fa
from repro.configs import get_config
from repro.configs.reduce import reduced
from repro.models import RuntimeOptions
from repro.models import api as japi
from repro.models import lm as jlm
from repro.serving import ServeEngine as JaxEngine
import repro_torch.kernels.decode_attention as tk
import repro_torch.kernels.flash_attention as tkf
import repro_torch.launch.serve as tserve
import repro_torch.models as tm
import repro_torch.models.lm as tlm
from repro_torch.configs import get_config as tget
from repro_torch.configs.reduce import reduced as treduced
from repro_torch.kernels import build as kbuild
from repro_torch.models import common as tcm
from repro_torch.models import sampling as tsam
from repro_torch.serving import ServeEngine
from torch_kernel_inputs import quantize as _quantize
from torch_kernel_inputs import t as _t

torch.set_num_threads(2)

TOL = {np.float32: 1e-5, "bfloat16": 2e-2}
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
CACHE_TOL = dict(atol=1e-5, rtol=1e-5)
ARCHS = ["llama3.2-1b", "qwen2.5-3b"]
COUNTERS = ("host_syncs", "decode_steps", "decode_compiles", "new_tokens",
            "requests")


def _j(a):
    return jnp.asarray(a)


def _in(rng, shape, dtype):
    """Seeded normal inputs for both packages in ``dtype`` (np.float32 or
    "bfloat16"): a JAX array and a torch tensor holding the same values."""
    a = rng.standard_normal(shape, dtype=np.float32)
    if dtype == "bfloat16":
        t = _t(a).to(torch.bfloat16)
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16), t
    return jnp.asarray(a), _t(a)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, dtype=np.float32),
                               atol=tol, rtol=tol)


# ------------------------------- kernels -------------------------------- #

@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("B,S,H,Hkv,dh,bq,bkv,causal", [
    (1, 256, 4, 4, 128, 128, 128, True),      # MHA
    (2, 512, 8, 2, 128, 256, 256, True),      # GQA 4:1
    (1, 384, 4, 1, 128, 128, 128, True),      # MQA, non-pow2 seq
    (1, 256, 16, 2, 128, 128, 128, True),     # GQA 8:1, qwen2.5-3b's group
    (1, 256, 4, 2, 64, 128, 128, True),       # head_dim 64
    (1, 256, 4, 4, 128, 128, 128, False),     # full (non-causal)
])
def test_flash_plain_matches_pallas(dtype, B, S, H, Hkv, dh, bq, bkv, causal):
    rng = np.random.default_rng(S + H)
    qj, qt = _in(rng, (B, S, H, dh), dtype)
    kj, kt = _in(rng, (B, S, Hkv, dh), dtype)
    vj, vt = _in(rng, (B, S, Hkv, dh), dtype)
    want = fa.flash_attention(qj, kj, vj, causal=causal, interpret=True,
                              block_q=bq, block_kv=bkv)
    got = tkf.flash_attention(qt, kt, vt, causal=causal)
    assert got.dtype == qt.dtype and got.shape == (B, S, H, dh)
    _close(got, want, TOL[dtype])


def test_flash_plain_takes_any_length():
    """The Pallas wrapper refuses a 300-token prompt with its default
    blocks; the port takes it. Causal rows before the padding of a padded
    Pallas call are the same function, so they must agree."""
    rng = np.random.default_rng(5)
    B, S, Sp, H, Hkv, dh = 2, 300, 384, 8, 2, 128
    q, k, v = (rng.standard_normal((B, Sp, h, dh), dtype=np.float32)
               for h in (H, Hkv, Hkv))
    with pytest.raises(AssertionError):
        fa.flash_attention(_j(q[:, :S]), _j(k[:, :S]), _j(v[:, :S]),
                           interpret=True)
    want = fa.flash_attention(_j(q), _j(k), _j(v), interpret=True,
                              block_q=128, block_kv=128)[:, :S]
    got = tkf.flash_attention(_t(q[:, :S]), _t(k[:, :S]), _t(v[:, :S]))
    _close(got, want, TOL[np.float32])


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("B,H,Hkv,dh,L,bkv", [
    (2, 4, 2, 128, 1024, 256),
    (1, 8, 1, 128, 512, 128),           # MQA
    (4, 4, 4, 64, 256, 128),            # small head_dim, MHA
    (4, 16, 2, 128, 545, 512),          # the static path: group 8, odd L
])
def test_decode_plain_matches_pallas(dtype, B, H, Hkv, dh, L, bkv):
    rng = np.random.default_rng(L)
    qj, qt = _in(rng, (B, H, dh), dtype)
    kj, kt = _in(rng, (B, L, Hkv, dh), dtype)
    vj, vt = _in(rng, (B, L, Hkv, dh), dtype)
    valid = rng.integers(1, L + 1, size=B).astype(np.int32)
    valid[0] = L
    want = da.decode_attention(qj, kj, vj, _j(valid), interpret=True,
                               block_kv=bkv)
    got = tk.decode_attention(qt, kt, vt, _t(valid))
    assert got.dtype == qt.dtype and got.shape == (B, H, dh)
    _close(got, want, TOL[dtype])


def test_decode_plain_int8_matches_int8_oracle():
    rng = np.random.default_rng(3)
    B, H, Hkv, dh, L = 2, 8, 2, 128, 1024
    q = rng.standard_normal((B, H, dh), dtype=np.float32)
    kc, ksc = _quantize(rng.standard_normal((B, L, Hkv, dh), dtype=np.float32))
    vc, vsc = _quantize(rng.standard_normal((B, L, Hkv, dh), dtype=np.float32))
    valid = np.asarray([L, L // 2], np.int32)
    want = da.decode_attention(_j(q), _j(kc), _j(vc), _j(valid),
                               k_scale=_j(ksc), v_scale=_j(vsc),
                               interpret=True, block_kv=256)
    got = tk.decode_attention(_t(q), _t(kc), _t(vc), _t(valid),
                              k_scale=_t(ksc), v_scale=_t(vsc))
    _close(got, want, TOL[np.float32])


def test_decode_plain_ignores_keys_past_valid():
    rng = np.random.default_rng(4)
    B, H, dh, L = 1, 4, 128, 512
    q = _t(rng.standard_normal((B, H, dh), dtype=np.float32))
    kc = _t(rng.standard_normal((B, L, H, dh), dtype=np.float32))
    vc = _t(rng.standard_normal((B, L, H, dh), dtype=np.float32))
    valid = torch.tensor([300], dtype=torch.int32)
    out1 = tk.decode_attention(q, kc, vc, valid)
    kc[:, 300:], vc[:, 300:] = 999.0, -999.0
    assert torch.equal(tk.decode_attention(q, kc, vc, valid), out1)


def test_cpu_tensors_take_the_plain_versions_and_do_not_count():
    q = torch.zeros((1, 4, 64))
    kc = torch.zeros((1, 8, 2, 64))
    n_dec, n_fl = tk.decode_attention.launches, tkf.flash_attention.launches
    tk.decode_attention(q, kc, kc, torch.tensor([3], dtype=torch.int32))
    tkf.flash_attention(q[:, None].expand(1, 8, 4, 64), kc, kc)
    assert tk.decode_attention.launches == n_dec
    assert tkf.flash_attention.launches == n_fl


def test_dense_decode_check_accepts_path_shapes():
    """The wrappers' argument check takes the static path's operands:
    q (B, H, dh) against a layer's (B, L, Hkv, dh) cache, bf16 or int8."""
    q = torch.zeros((4, 16, 128), dtype=torch.bfloat16)
    for dt in (torch.bfloat16, torch.int8):
        cache = torch.zeros((36, 4, 545, 2, 128), dtype=dt)
        sc = torch.ones((36, 2)) if dt == torch.int8 else None
        tk._check(q, cache[3], cache[3], None if sc is None else sc[3],
                  None if sc is None else sc[3],
                  (torch.full((4,), 300, dtype=torch.int32),), q_ndim=3)
    with pytest.raises(ValueError, match="k_scale"):
        tk._check(q, cache[3], cache[3], None, None,
                  (torch.ones((4,), dtype=torch.int32),), q_ndim=3)


def test_update_cache_writes_in_place_and_refuses_overrun():
    ck, cv = torch.zeros((2, 6, 1, 4)), torch.zeros((2, 6, 1, 4))
    kn, vn = torch.ones((2, 2, 1, 4)), 2 * torch.ones((2, 2, 1, 4))
    out = tcm.update_cache(ck, cv, kn, vn, 3)
    assert out[0] is ck and float(ck[:, 3:5].min()) == 1.0
    assert float(cv[:, 3:5].min()) == 2.0 and float(ck[:, :3].abs().max()) == 0
    with pytest.raises(ValueError, match="past the cache"):
        tcm.update_cache(ck, cv, kn, vn, 5)


def test_builds_every_source_from_one_place():
    """All four CUDA sources build from kernels.build, each keyed by the
    hash of its own source and of the headers it includes."""
    assert set(kbuild.SOURCES) == {"paged_decode_attention",
                                   "chunk_prefill_attention",
                                   "decode_attention", "flash_attention"}
    extra = {"decode_attention": {"split_decode.cuh"},
             "paged_decode_attention": {"split_decode.cuh"},
             "flash_attention": {"mma_tile.cuh", "wide_mma.cuh"},
             "chunk_prefill_attention": {"mma_tile.cuh", "split_decode.cuh",
                                         "wide_mma.cuh"}}
    for name in kbuild.SOURCES:
        # every source takes the width-generic body above head width 512
        assert set(kbuild.headers(name)) == {"dispatch.cuh",
                                             "paged_attention.cuh",
                                             "wide_tile.cuh"} | extra.get(
                                                 name, set())
        assert kbuild.lib_path(name).name.startswith(name + "_")
    hashes = {kbuild.source_hash(n) for n in kbuild.SOURCES}
    assert len(hashes) == len(kbuild.SOURCES)


# -------------------------------- model --------------------------------- #

@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    cfg = reduced(get_config(arch), d_model=64, n_layers=2, vocab=128)
    tcfg = treduced(tget(arch), d_model=64, n_layers=2, vocab=128)
    jp = jlm.init_params(cfg, jax.random.PRNGKey(0),
                         RuntimeOptions(dtype="float32"))
    tp = tm.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    return cfg, tcfg, jp, tp


def _opts(cache_dtype, attn_impl="xla"):
    return (RuntimeOptions(dtype="float32", cache_dtype=cache_dtype,
                           attn_impl=attn_impl),
            tm.RuntimeOptions(dtype="float32", cache_dtype=cache_dtype))


def _assert_cache(tcache, jcache):
    for name, arr in jcache["stack"].items():
        got = tcache["stack"][name]
        if arr.dtype == jnp.int8:
            np.testing.assert_array_equal(got.numpy(), np.asarray(arr),
                                          err_msg=name)
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(arr),
                                       **CACHE_TOL, err_msg=name)


def test_static_supported_names_roadmap_items():
    assert tm.static_supported(tget("qwen2.5-3b")) is None
    assert tm.static_supported(tget("llama3.2-1b")) is None
    assert tm.static_supported(tget("arctic-480b")) is None      # MoE
    # the VLMs, prefix-LM, local:global and soft-capped configs
    for arch in ("llava15-13b", "paligemma-3b", "gemma3-1b"):
        assert tm.static_supported(tget(arch)) is None, arch
    # the last four families (ROADMAP.md A10.3), each through its module
    from repro_torch.models import mamba_lm, whisper, zamba
    for arch, mod in [("whisper-medium", whisper), ("zamba2-2.7b", zamba),
                      ("deepseek-v2-236b", tlm), ("mamba2-130m", mamba_lm)]:
        assert tm.static_supported(tget(arch)) is None, arch
        assert tm.module_for(tget(arch)) is mod, arch
    assert tm.module_for(tget("arctic-480b")) is tlm
    assert tm.module_for(tget("mamba2-130m")) is mamba_lm
    assert tm.module_for(tget("qwen2.5-3b")).static_supported is \
        tlm.static_supported


def test_forward_collect_kv_matches(model):
    cfg, tcfg, jp, tp = model
    jo, to = _opts("")
    toks = np.random.default_rng(1).integers(1, cfg.vocab, size=(3, 9))
    jl, _, (_, (jk, jv)) = jlm.forward(cfg, jp, _j(toks.astype(np.int32)),
                                       jo, collect_kv=True)
    tl, kvs = tm.forward(tcfg, tp, _t(toks.astype(np.int32)), to,
                         collect_kv=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    assert len(kvs) == cfg.n_layers
    for i, (k, v) in enumerate(kvs):
        np.testing.assert_allclose(k.numpy(), np.asarray(jk[i]), **CACHE_TOL)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv[i]), **CACHE_TOL)


@pytest.mark.parametrize("cache_dtype", ["", "int8"])
def test_prefill_and_decode_match(model, cache_dtype):
    """prefill, three decode steps (scalar positions, as the static engine
    decodes) and a fused 5-step greedy block, logits and caches."""
    cfg, tcfg, jp, tp = model
    jo, to = _opts(cache_dtype)
    B, S, Lmax = 3, 9, 20
    toks = np.random.default_rng(2).integers(1, cfg.vocab, size=(B, S))
    toks = toks.astype(np.int32)
    jc = jlm.init_cache(cfg, B, Lmax, jo)
    tc = tm.init_cache(tcfg, B, Lmax, to, device="cpu")
    jl, jc = jlm.prefill(cfg, jp, _j(toks), jc, jo)
    tl, tc = tm.prefill(tcfg, tp, _t(toks), tc, to)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _assert_cache(tc, jc)
    tok = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)
    for pos in range(S, S + 3):
        jl, jc = jlm.decode_step(cfg, jp, _j(tok), jnp.int32(pos), jc, jo)
        tl, tc = tm.decode_step(tcfg, tp, _t(tok), pos, tc, to)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        _assert_cache(tc, jc)
        tok = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)
    jt, jc = japi.decode_steps(cfg, jp, _j(tok), jnp.int32(S + 3), jc, 5, jo)
    tt, tc = tm.decode_steps(tcfg, tp, _t(tok), S + 3, tc, 5, to)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    _assert_cache(tc, jc)


def test_decode_steps_sampled_is_the_per_token_loop(model):
    """A sampled fused block draws step j's noise at token index + j of
    each slot's key: the same tokens as one decode_step and one sample a
    step."""
    _, tcfg, _, tp = model
    to = tm.RuntimeOptions(dtype="float32")
    toks = _t(np.random.default_rng(3).integers(1, tcfg.vocab, size=(2, 6))
              .astype(np.int32))
    keys = tsam.request_keys(9, torch.tensor([4, 7]), torch.tensor([1, 3]))
    kw = dict(temperature=0.9, top_k=20, top_p=0.95)
    caches = [tm.init_cache(tcfg, 2, 12, to, device="cpu") for _ in range(2)]
    lg, _ = tm.prefill(tcfg, tp, toks, caches[0], to)
    tm.prefill(tcfg, tp, toks, caches[1], to)
    tok0 = tsam.sample_greedy(lg)
    blk, _ = tm.decode_steps(tcfg, tp, tok0, 6, caches[0], 4, to, keys=keys,
                             **kw)
    tok, want = tok0, []
    for j in range(4):
        lg, _ = tm.decode_step(tcfg, tp, tok, 6 + j, caches[1], to)
        tok = tsam.sample(lg, tsam.gumbel(tsam.advance(keys, j), tcfg.vocab),
                          **kw)
        want.append(tok)
    assert torch.equal(blk, torch.stack(want, dim=1))
    with pytest.raises(ValueError, match="keys"):
        tm.decode_steps(tcfg, tp, tok0, 6, caches[0], 2, to, temperature=0.5)


def test_prefill_matches_pallas_flash_route():
    """With head_dim 128 and a 128-token prompt the reference's prefill
    attention goes through its Pallas flash kernel (attn_impl="pallas",
    interpret mode); the port's prefill through its flash entry."""
    cfg = dataclasses.replace(
        reduced(get_config("qwen2.5-3b"), d_model=64, n_layers=2, vocab=128),
        head_dim=128)
    tcfg = dataclasses.replace(
        treduced(tget("qwen2.5-3b"), d_model=64, n_layers=2, vocab=128),
        head_dim=128)
    jp = jlm.init_params(cfg, jax.random.PRNGKey(1),
                         RuntimeOptions(dtype="float32"))
    tp = tm.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    jo, to = _opts("", attn_impl="pallas")
    toks = np.random.default_rng(4).integers(1, cfg.vocab, size=(1, 128))
    toks = toks.astype(np.int32)
    jc = jlm.init_cache(cfg, 1, 130, jo)
    tc = tm.init_cache(tcfg, 1, 130, to, device="cpu")
    jl, jc = jlm.prefill(cfg, jp, _j(toks), jc, jo)
    tl, tc = tm.prefill(tcfg, tp, _t(toks), tc, to)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _assert_cache(tc, jc)


# -------------------------------- engine -------------------------------- #

def _requests(vocab):
    """Seven ragged prompts in three length buckets."""
    rng = np.random.default_rng(3)
    return [rng.integers(1, vocab, size=n).tolist()
            for n in (5, 7, 5, 9, 7, 5, 9)]


def _stats(eng):
    return {c: getattr(eng.stats, c) for c in COUNTERS}


def _port(model, **kw):
    _, tcfg, _, tp = model
    args = dict(device="cpu", scheduler="static", max_len=40)
    args.update(kw)
    return ServeEngine(tcfg, tp, tm.RuntimeOptions(dtype="float32"), **args)


def _reference(model, **kw):
    cfg, _, jp, _ = model
    return JaxEngine(cfg, jp, RuntimeOptions(dtype="float32"), max_len=40,
                     **kw)


@pytest.mark.parametrize("K", [1, 8])
@pytest.mark.parametrize("kv_policy", ["native", "int8"])
def test_static_engine_matches_reference(model, kv_policy, K):
    """serve_bucketed (one generate a length bucket): the reference's
    tokens, host syncs, launched micro-steps and decode shapes."""
    reqs = _requests(model[0].vocab)
    ref = _reference(model, kv_policy=kv_policy, decode_lookahead=K)
    want = ref.serve([r[:] for r in reqs], 11)
    eng = _port(model, kv_policy=kv_policy, decode_lookahead=K)
    assert eng.serve([r[:] for r in reqs], 11) == want
    assert _stats(eng) == _stats(ref)
    assert eng.stats.prefill_s > 0 and eng.stats.decode_s > 0


def _eos_mid_block(model, prompt):
    """A token that the K=1 greedy output of ``prompt`` emits first at an
    index inside the second pull of a K=8 run (1..7, not a block edge)."""
    out = _port(model, decode_lookahead=1).generate([prompt], 12)[0]
    for j in range(2, 8):
        if out[j] not in out[:j]:
            return out[j], j
    raise AssertionError(f"no mid-block EOS candidate in {out}")


@pytest.mark.parametrize("kv_policy", ["native", "int8"])
def test_static_eos_mid_block_matches_reference(model, kv_policy):
    prompt = np.random.default_rng(21).integers(1, model[0].vocab,
                                                size=6).tolist()
    eos, j = _eos_mid_block(model, prompt)
    outs = {}
    for K in (1, 8):
        ref = _reference(model, kv_policy=kv_policy, decode_lookahead=K,
                         eos_id=eos)
        want = ref.generate(np.asarray([prompt]), 12)
        eng = _port(model, kv_policy=kv_policy, decode_lookahead=K,
                    eos_id=eos)
        outs[K] = eng.generate([prompt], 12)
        assert outs[K] == want and _stats(eng) == _stats(ref)
    assert outs[1] == outs[8]
    assert len(outs[8][0]) == j + 1 and outs[8][0][-1] == eos


def test_static_matches_continuous(model):
    """Token identity of the two port engines on the same requests, as
    the reference's serve_batched example asserts for its own."""
    reqs = _requests(model[0].vocab)
    static = _port(model).serve([r[:] for r in reqs], 11)
    cont = _port(model, scheduler="continuous", page_size=4, max_batch=4,
                 prefill_chunk=8, overlap=False)
    assert cont.serve([r[:] for r in reqs], 11) == static


def test_sampled_loop_with_reference_noise(model):
    """The non-greedy per-token loop fed the Gumbel noise of the
    reference's ``jax.random.categorical`` keys gives its tokens; left to
    its own counter-based draws it is repeatable under one seed."""
    cfg = model[0]
    prompts = np.random.default_rng(8).integers(1, cfg.vocab, size=(3, 6))
    n, seed = 7, 5
    ref = _reference(model)
    want = ref.generate(prompts, n, greedy=False, seed=seed)
    key, noise = jax.random.PRNGKey(seed), []
    for _ in range(n):
        key, sub = jax.random.split(key)
        noise.append(np.asarray(jax.random.gumbel(sub, (3, cfg.vocab),
                                                  jnp.float32)))
    eng = _port(model)
    assert eng.generate(prompts, n, greedy=False, noise=noise) == want
    assert _stats(eng) == _stats(ref)
    own = [_port(model).generate(prompts, n, greedy=False, seed=seed)
           for _ in range(2)]
    assert own[0] == own[1]
    assert all(0 <= t < cfg.vocab for row in own[0] for t in row)


def test_static_engine_contract(model):
    _, tcfg, _, tp = model
    with pytest.raises(ValueError, match="continuous"):
        ServeEngine(tcfg, tp, device="cpu", scheduler="static",
                    spec_mode="ngram")
    eng = _port(model, max_len=12)
    with pytest.raises(ValueError, match="max_len"):
        eng.generate(np.ones((1, 8), np.int32), 5)


@pytest.mark.parametrize("extra,n_reqs", [([], 2),
                                          (["--concurrency", "5"], 5)])
def test_serve_cli_static(capsys, extra, n_reqs):
    """--scheduler static: one --batch x --prompt-len wave through
    generate, or --concurrency ragged requests through serve_bucketed."""
    tserve.main(["--arch", "qwen2.5-3b", "--reduced", "--d-model", "64",
                 "--device", "cpu", "--scheduler", "static", "--batch", "2",
                 "--prompt-len", "10", "--new-tokens", "5",
                 "--kv-policy", "int8", *extra])
    out = capsys.readouterr().out
    assert (f"[serve] arch=qwen2.5-3b device=cpu sched=static kv=int8 "
            f"reqs={n_reqs} ") in out
    assert "TPS=" in out and "[serve] first output:" in out
    assert "prefill_toks=" not in out        # continuous-only report
