"""The VLM family and the general masked attention on the port's static
engine against the reference's, on the CPU.

Three configs, reduced with ``n_layers=6`` so that gemma3's one global
layer (layer 5; its first five are local) exists, in f32 with the
reference's weights:

* llava15-13b (VLM, MHA, causal; its prompt attention takes the flash
  entry, its decode the dense decode entry);
* paligemma-3b (VLM, prefix-LM: the first ``prefix_len`` positions attend
  bidirectionally, through the masked attention, with or without a
  ``prefix_emb``; decode on the dense decode entry);
* gemma3-1b (5 local sliding-window layers to 1 global, soft-capped
  logits: every layer through the masked attention).

``forward(collect_kv)``, ``prefill`` and ``decode_step`` against
``repro.models.lm`` (logits and caches, native and int8), then
``ServeEngine(scheduler="static")`` token-identical to the reference's at
temperature 0 with equal counters (``generate`` with the same
``prefix_emb`` and without one, ``serve_bucketed``, native and int8), the
routes each layer takes (entry launches on CPU tensors do not count, so
the calls of the masked attention and of the plain versions are counted),
the gates, and the CLI. The dense decode's plain version and split
mirror at head width 256 (paligemma-3b's width) against the Pallas
kernel in interpret mode, and the head-width check of each kernel.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.decode_attention as da
import repro_torch.kernels.decode_attention as tk
import repro_torch.kernels.flash_attention as tkf
import repro_torch.launch.serve as tserve
import repro_torch.models as tm
from repro.configs import get_config
from repro.configs.reduce import reduced
from repro.models import RuntimeOptions
from repro.models import lm as jlm
from repro.serving import ServeEngine as JaxEngine
from repro_torch.configs import get_config as tget
from repro_torch.configs.reduce import reduced as treduced
from repro_torch.models import common as tcm
from repro_torch.models import lm as tlm
from repro_torch.serving import ServeEngine
from torch_kernel_inputs import PALIGEMMA_WIDTH
from torch_kernel_inputs import quantize as _quantize
from torch_kernel_inputs import t as _t

torch.set_num_threads(2)

ARCHS = ["llava15-13b", "paligemma-3b", "gemma3-1b"]
VLM = ("llava15-13b", "paligemma-3b")
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
CACHE_TOL = dict(atol=1e-5, rtol=1e-5)
COUNTERS = ("host_syncs", "decode_steps", "decode_compiles", "new_tokens",
            "requests")
MAX_LEN = 48


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    cfg = reduced(get_config(arch), d_model=64, n_layers=6, vocab=128)
    tcfg = treduced(tget(arch), d_model=64, n_layers=6, vocab=128)
    jp = jlm.init_params(cfg, jax.random.PRNGKey(0),
                         RuntimeOptions(dtype="float32"))
    tp = tm.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    return arch, cfg, tcfg, jp, tp


def _prefix(cfg, B, seed=11):
    """A (B, prefix_len, d) stub frontend output (VLM patches)."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, cfg.prefix_len, cfg.d_model),
                               dtype=np.float32)


def _opts(cache_dtype=""):
    return (RuntimeOptions(dtype="float32", cache_dtype=cache_dtype),
            tm.RuntimeOptions(dtype="float32", cache_dtype=cache_dtype))


# -------------------------------- gates --------------------------------- #

def test_gates_admit_the_dense_cache_families():
    for arch in ARCHS:
        cfg = tget(arch)
        assert tm.static_supported(cfg) is None, arch
        assert tm.module_for(cfg) is tlm
    # the reference's paged path covers dense and MoE only, and no windows
    assert "not covered by the paged KV path" in tlm.paged_supported(
        tget("llava15-13b"))
    assert "family 'vlm'" in tlm.paged_supported(tget("paligemma-3b"))
    assert "sliding-window" in tlm.paged_supported(tget("gemma3-1b"))


def test_kind_array_is_the_references():
    for arch in ARCHS:
        cfg = get_config(arch)
        want = np.asarray(jlm._kind_array(cfg, 0, cfg.n_layers)).tolist()
        assert tlm._kind_array(tget(arch), 0, cfg.n_layers) == want
    kinds = tlm._kind_array(tget("gemma3-1b"), 0, 26)
    assert [i for i, k in enumerate(kinds) if k == 0] == [5, 11, 17, 23]


# ------------------------- dense decode at 256 -------------------------- #

@pytest.mark.parametrize("quant", [False, True])
def test_dense_decode_plain_at_256_matches_pallas(quant):
    """paligemma-3b's decode width (8 heads over 1 KV head, head_dim 256),
    ragged kv_valid, f32 or an int8 cache, against the Pallas kernel."""
    H, Hkv, dh = PALIGEMMA_WIDTH
    B, L = 4, 512
    rng = np.random.default_rng(256)
    q = rng.standard_normal((B, H, dh), dtype=np.float32)
    kc = rng.standard_normal((B, L, Hkv, dh), dtype=np.float32)
    vc = rng.standard_normal((B, L, Hkv, dh), dtype=np.float32)
    valid = np.asarray([L, 1, 300, 129], np.int32)
    jkw, tkw = {}, {}
    if quant:
        kc, ksc = _quantize(kc)
        vc, vsc = _quantize(vc)
        jkw = dict(k_scale=jnp.asarray(ksc), v_scale=jnp.asarray(vsc))
        tkw = dict(k_scale=_t(ksc), v_scale=_t(vsc))
    want = da.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                               jnp.asarray(vc), jnp.asarray(valid),
                               interpret=True, block_kv=128, **jkw)
    got = tk.decode_attention(_t(q), _t(kc), _t(vc), _t(valid), **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    # the kernel's two passes at the split the card takes for this shape
    split = tk.decode_split(B, Hkv, L, H // Hkv, 132)
    mirror, _ = tk._decode_split_plain(_t(q), _t(kc), _t(vc), _t(valid),
                                       split, **tkw)
    np.testing.assert_allclose(mirror.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_head_width_check_is_per_kernel():
    """Every kernel is built for head width 256 (the dense decode, flash,
    the paged decode, the chunk and the verify window share one check and
    one tuple of widths): the check takes paligemma-3b's width for a decode
    query and for a chunk or prompt, and refuses a width no kernel is built
    for (96), on which the wrappers then raise on the card."""
    H, Hkv, dh = PALIGEMMA_WIDTH
    q = torch.zeros((2, H, dh))
    kc = torch.zeros((2, 16, Hkv, dh))
    valid = torch.ones((2,), dtype=torch.int32)
    tk._check(q, kc, kc, None, None, (valid,), q_ndim=3)
    tk._check(torch.zeros((2, 16, H, dh)), kc, kc, None, None, (valid,),
              q_ndim=4)
    assert tk._HEAD_DIMS == (64, 128, 256, 384, 512)
    with pytest.raises(ValueError, match="head_dim 96"):
        tk._check(q[..., :96], kc[..., :96], kc[..., :96], None, None,
                  (valid,), q_ndim=3)


# -------------------------------- model --------------------------------- #

def test_forward_collect_kv_matches(model):
    arch, cfg, tcfg, jp, tp = model
    jo, to = _opts()
    toks = np.random.default_rng(1).integers(1, cfg.vocab, size=(2, 13))
    toks = toks.astype(np.int32)
    pfx = _prefix(cfg, 2) if arch in VLM else None
    jl, _, (_, (jk, jv)) = jlm.forward(
        cfg, jp, jnp.asarray(toks), jo,
        prefix_emb=None if pfx is None else jnp.asarray(pfx),
        collect_kv=True)
    tl, kvs = tm.forward(tcfg, tp, _t(toks), to,
                         None if pfx is None else _t(pfx), collect_kv=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    assert len(kvs) == cfg.n_layers
    for i, (k, v) in enumerate(kvs):
        np.testing.assert_allclose(k.numpy(), np.asarray(jk[i]), **CACHE_TOL)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv[i]), **CACHE_TOL)


def _assert_cache(tcache, jcache):
    for name, arr in jcache["stack"].items():
        got = tcache["stack"][name]
        if arr.dtype == jnp.int8:
            np.testing.assert_array_equal(got.numpy(), np.asarray(arr),
                                          err_msg=name)
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(arr),
                                       **CACHE_TOL, err_msg=name)


@pytest.mark.parametrize("cache_dtype", ["", "int8"])
def test_prefill_and_decode_match(model, cache_dtype):
    """prefill (with the prefix for the VLMs) and decode steps past the
    reduced sliding window (8), logits and caches."""
    arch, cfg, tcfg, jp, tp = model
    jo, to = _opts(cache_dtype)
    B, S = 2, 9
    P = cfg.prefix_len if arch in VLM else 0
    Lmax = P + S + 6
    toks = np.random.default_rng(2).integers(1, cfg.vocab, size=(B, S))
    toks = toks.astype(np.int32)
    pfx = _prefix(cfg, B) if P else None
    jc = jlm.init_cache(cfg, B, Lmax, jo)
    tc = tm.init_cache(tcfg, B, Lmax, to, device="cpu")
    jl, jc = jlm.prefill(cfg, jp, jnp.asarray(toks), jc, jo,
                         prefix_emb=None if pfx is None else jnp.asarray(pfx))
    tl, tc = tm.prefill(tcfg, tp, _t(toks), tc, to,
                        None if pfx is None else _t(pfx))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _assert_cache(tc, jc)
    tok = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)
    for pos in range(P + S, Lmax):
        jl, jc = jlm.decode_step(cfg, jp, jnp.asarray(tok), jnp.int32(pos),
                                 jc, jo)
        tl, tc = tm.decode_step(tcfg, tp, _t(tok), pos, tc, to)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        _assert_cache(tc, jc)
        tok = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)


@pytest.mark.parametrize("arch,flash,masked", [
    ("llava15-13b", 6, 0),          # causal, no soft-cap: flash
    ("paligemma-3b", 0, 6),         # prefix-LM: masked
    ("gemma3-1b", 0, 6),            # soft-capped (and 5 windows): masked
])
def test_prompt_routes(monkeypatch, arch, flash, masked):
    """Which entry each layer's prompt attention and decode attention
    takes: flash and the dense decode where the reference would take its
    Pallas kernels, the masked attention elsewhere (decode: only the
    sliding or soft-capped layers)."""
    tcfg = treduced(tget(arch), d_model=64, n_layers=6, vocab=128)
    tp = tm.init_params(tcfg, torch.Generator().manual_seed(0), "float32",
                        "cpu")
    calls = {"flash": 0, "decode": 0}
    for mod, name, key in ((tkf, "flash_attention_plain", "flash"),
                           (tk, "decode_attention_plain", "decode")):
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, _key=key, **kw):
            calls[_key] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    to = tm.RuntimeOptions(dtype="float32")
    cache = tm.init_cache(tcfg, 1, 16, to, device="cpu")
    n0 = tcm.attention.calls
    tm.prefill(tcfg, tp, torch.ones((1, 12), dtype=torch.int32), cache, to)
    assert calls["flash"] == flash
    assert tcm.attention.calls - n0 == masked
    n0 = tcm.attention.calls
    tm.decode_step(tcfg, tp, torch.ones((1,), dtype=torch.int32), 12,
                   cache, to)
    dense = 0 if arch == "gemma3-1b" else 6
    assert calls["decode"] == dense
    assert tcm.attention.calls - n0 == 6 - dense


# -------------------------------- engine -------------------------------- #

def _engines(model, kv_policy, K=8):
    _, cfg, tcfg, jp, tp = model
    ref = JaxEngine(cfg, jp, RuntimeOptions(dtype="float32"),
                    max_len=MAX_LEN, kv_policy=kv_policy, decode_lookahead=K)
    port = ServeEngine(tcfg, tp, tm.RuntimeOptions(dtype="float32"),
                       device="cpu", scheduler="static", max_len=MAX_LEN,
                       kv_policy=kv_policy, decode_lookahead=K)
    return ref, port


def _stats(eng):
    return {c: getattr(eng.stats, c) for c in COUNTERS}


@pytest.mark.parametrize("K", [1, 8])
@pytest.mark.parametrize("kv_policy", ["native", "int8"])
def test_generate_matches_reference(model, kv_policy, K):
    """One static wave: the VLMs with the same prefix_emb (patches), gemma3
    on its prompt alone; 14 new tokens carry the decode past the reduced
    window."""
    arch, cfg = model[:2]
    prompts = np.random.default_rng(5).integers(1, cfg.vocab, size=(3, 10))
    prompts = prompts.astype(np.int32)
    kw = dict(prefix_emb=_prefix(cfg, 3)) if arch in VLM else {}
    ref, port = _engines(model, kv_policy, K)
    want = ref.generate(prompts, 14, **kw)
    assert port.generate(prompts, 14, **kw) == want
    assert _stats(port) == _stats(ref)


@pytest.mark.parametrize("kv_policy", ["native", "int8"])
def test_paligemma_without_prefix_matches_reference(kv_policy):
    """No prefix_emb: the first prefix_len prompt tokens attend
    bidirectionally all the same (the CLI's case); the prefix-LM mask
    reaches the output."""
    cfg = reduced(get_config("paligemma-3b"), d_model=64, n_layers=6,
                  vocab=128)
    tcfg = treduced(tget("paligemma-3b"), d_model=64, n_layers=6, vocab=128)
    jp = jlm.init_params(cfg, jax.random.PRNGKey(3),
                         RuntimeOptions(dtype="float32"))
    tp = tm.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    model = ("paligemma-3b", cfg, tcfg, jp, tp)
    prompts = np.random.default_rng(6).integers(1, cfg.vocab, size=(2, 12))
    prompts = prompts.astype(np.int32)
    ref, port = _engines(model, kv_policy)
    want = ref.generate(prompts, 10)
    got = port.generate(prompts, 10)
    assert got == want and _stats(port) == _stats(ref)
    # the same weights attending causally decode otherwise
    causal = ServeEngine(dataclasses.replace(tcfg,
                                             prefix_bidirectional=False),
                         tp, tm.RuntimeOptions(dtype="float32"),
                         device="cpu", scheduler="static", max_len=MAX_LEN,
                         kv_policy=kv_policy)
    assert causal.generate(prompts, 10) != got


@pytest.mark.parametrize("kv_policy", ["native", "int8"])
def test_serve_bucketed_matches_reference(model, kv_policy):
    """serve_bucketed: seven ragged prompts in three length buckets, one
    generate a bucket, no patches (as the CLI serves them)."""
    cfg = model[1]
    rng = np.random.default_rng(3)
    reqs = [rng.integers(1, cfg.vocab, size=n).tolist()
            for n in (5, 12, 5, 14, 12, 5, 14)]
    ref, port = _engines(model, kv_policy)
    want = ref.serve([r[:] for r in reqs], 11)
    assert port.serve([r[:] for r in reqs], 11) == want
    assert _stats(port) == _stats(ref)


# --------------------------------- CLI ---------------------------------- #

@pytest.mark.parametrize("arch", VLM)
def test_serve_cli_vlm_static(capsys, arch):
    tserve.main(["--arch", arch, "--reduced", "--d-model", "64",
                 "--device", "cpu", "--batch", "2", "--prompt-len", "12",
                 "--new-tokens", "4"])
    out = capsys.readouterr().out
    assert (f"[serve] arch={arch} device=cpu sched=static kv=native "
            f"reqs=2 ") in out
    assert "[serve] first output:" in out


@pytest.mark.parametrize("arch", VLM)
def test_serve_cli_vlm_continuous_raises(arch):
    with pytest.raises(NotImplementedError,
                       match="family 'vlm' is not covered by the paged"):
        tserve.main(["--arch", arch, "--reduced", "--device", "cpu",
                     "--scheduler", "continuous"])
