"""The Whisper encoder-decoder on the port's static engine, against the
reference on the CPU.

whisper-medium reduced (2 encoder and 4 decoder layers, 12 stub frames,
d_model 64, 4 heads of 16), in f32 with the reference's weights: the
LayerNorm and sinusoid, ``encode``, ``forward``, ``prefill`` and
``decode_step`` (logits, the self and cross caches), teacher-forced decode
at ``pos = S`` against the forward, and ``ServeEngine(scheduler=
"static").generate`` with the same frames token- and counter-identical to
the reference's, including the reference's decode offset (it decodes at
``S + source_len``: ROADMAP.md queue C), which this file pins. An int8 KV
cache raises, and so do a forward and the CLI without frames.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.launch.serve as tserve
import repro_torch.models as tm
from repro.models import api as japi
from repro.models import common as jcm
from repro.models import whisper as jwhisper
from repro_torch.configs import get_config as tget
from repro_torch.models import common as tcm
from repro_torch.models import lm as tlm
from repro_torch.models import whisper as twhisper
from torch_family_helpers import (CACHE_TOL, LOGIT_TOL, assert_same_layout,
                                  assert_tree_close, engines, family_model,
                                  opts, stats)
from torch_kernel_inputs import t as _t

torch.set_num_threads(2)

ARCH = "whisper-medium"
MAX_LEN = 48


@pytest.fixture(scope="module")
def model():
    return family_model(ARCH)


def _frames(cfg, B, seed=11):
    """(B, source_len, d) stub frame embeddings."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, cfg.source_len, cfg.d_model),
                               dtype=np.float32)


def test_gates_and_layout(model):
    cfg, tcfg, jp, tp = model
    assert tm.static_supported(tget(ARCH)) is None
    assert tm.module_for(tget(ARCH)) is twhisper
    assert tm.paged_supported(tget(ARCH)) == (
        "family 'encdec' has no paged serving path")
    assert tlm.paged_supported(tget(ARCH)) == (
        "family 'encdec' is not covered by the paged KV path")
    assert "b" not in tp["dec_stack"]["self"]["wk"]      # keys: no bias
    assert "b" in tp["dec_stack"]["cross"]["wq"]
    own = tm.init_params(tcfg, torch.Generator().manual_seed(0), "float32",
                         "cpu")
    assert_same_layout(own, jp)


def test_layer_norm_and_sinusoid_match():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 32), dtype=np.float32) * 3 + 1
    w = rng.standard_normal((32,), dtype=np.float32)
    b = rng.standard_normal((32,), dtype=np.float32)
    np.testing.assert_allclose(tcm.layer_norm(_t(x), _t(w), _t(b)).numpy(),
                               np.asarray(jcm.layer_norm(*map(jnp.asarray,
                                                              (x, w, b)))),
                               **CACHE_TOL)
    np.testing.assert_allclose(tcm.sinusoid(1500, 64).numpy(),
                               np.asarray(jwhisper._sinusoid(1500, 64)),
                               atol=1e-4, rtol=1e-5)


def test_encode_matches(model):
    cfg, tcfg, jp, tp = model
    jo, to = opts()
    fr = _frames(cfg, 2)
    want = jwhisper.encode(cfg, jp, jnp.asarray(fr), jo)
    got = twhisper.encode(tcfg, tp, _t(fr), to)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CACHE_TOL)


def test_forward_prefill_decode_match(model):
    cfg, tcfg, jp, tp = model
    jo, to = opts()
    B, S, Lmax = 2, 9, 14
    toks = np.random.default_rng(2).integers(1, cfg.vocab, size=(B, S))
    toks = toks.astype(np.int32)
    fr = _frames(cfg, B)
    want, _ = japi.forward(cfg, jp, jnp.asarray(toks), jo,
                           prefix_emb=jnp.asarray(fr))
    got = tm.forward(tcfg, tp, _t(toks), to, _t(fr))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    jc = japi.init_cache(cfg, B, Lmax, jo)
    tc = tm.init_cache(tcfg, B, Lmax, to, device="cpu")
    jl, jc = japi.prefill(cfg, jp, jnp.asarray(toks), jc, jo,
                          prefix_emb=jnp.asarray(fr))
    tl, tc = tm.prefill(tcfg, tp, _t(toks), tc, to, _t(fr))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    assert_tree_close(tc, jc, **CACHE_TOL)
    tok = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)
    for pos in range(S, Lmax):
        jl, jc = japi.decode_step(cfg, jp, jnp.asarray(tok), jnp.int32(pos),
                                  jc, jo)
        tl, tc = tm.decode_step(tcfg, tp, _t(tok), pos, tc, to)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        assert_tree_close(tc, jc, **CACHE_TOL)
        tok = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)


def test_decode_matches_forward_at_s(model):
    """Teacher-forced decode at pos = S (the decoder's own positions) ==
    the forward; at pos = S + source_len, where both engines' ``generate``
    decode, it is not (ROADMAP.md queue C)."""
    cfg, tcfg, _, tp = model
    to = tm.RuntimeOptions(dtype="float32")
    toks = _t(np.random.default_rng(3).integers(1, tcfg.vocab, size=(2, 10))
              .astype(np.int32))
    fr = _t(_frames(cfg, 2))
    full = tm.forward(tcfg, tp, toks, to, fr)
    errs, off = [], []
    for shift, out in ((0, errs), (cfg.source_len, off)):
        cache = tm.init_cache(tcfg, 2, 10 + shift, to, device="cpu")
        lg, cache = tm.prefill(tcfg, tp, toks[:, :6], cache, to, fr)
        for t in range(6, 10):
            lg, cache = tm.decode_step(tcfg, tp, toks[:, t], t + shift,
                                       cache, to)
            out.append(float((lg - full[:, t]).abs().max()))
    assert max(errs) < 1e-4, errs
    assert min(off) > 1e-2, off


def test_masked_attention_calls(model):
    """3 a decoder layer in the prompt (with the encoder's one a layer),
    2 a decoder layer in a decode step; no kernel entry."""
    cfg, tcfg, _, tp = model
    to = tm.RuntimeOptions(dtype="float32")
    cache = tm.init_cache(tcfg, 1, 16, to, device="cpu")
    n0 = tcm.attention.calls
    tm.prefill(tcfg, tp, torch.ones((1, 8), dtype=torch.int32), cache, to,
               _t(_frames(cfg, 1)))
    assert tcm.attention.calls - n0 == cfg.enc_layers + 2 * cfg.n_layers
    n0 = tcm.attention.calls
    tm.decode_step(tcfg, tp, torch.ones((1,), dtype=torch.int32), 8, cache,
                   to)
    assert tcm.attention.calls - n0 == 2 * cfg.n_layers


def test_refusals(model):
    cfg, tcfg, _, tp = model
    to = tm.RuntimeOptions(dtype="float32", cache_dtype="int8")
    with pytest.raises(NotImplementedError,
                       match=r"whisper\.py:161.*ROADMAP\.md queue C"):
        tm.init_cache(tcfg, 1, 16, to, device="cpu")
    with pytest.raises(ValueError, match="frame embeddings"):
        tm.forward(tcfg, tp, torch.ones((1, 4), dtype=torch.int32))


@pytest.mark.parametrize("K", [1, 8])
def test_generate_matches_reference(model, K):
    """The same frames before 3 prompts of 10 tokens, 14 new: the same
    tokens and counters, the reference's decode offset included."""
    cfg = model[0]
    prompts = np.random.default_rng(5).integers(1, cfg.vocab, size=(3, 10))
    prompts = prompts.astype(np.int32)
    fr = _frames(cfg, 3)
    ref, port = engines(model, max_len=MAX_LEN, K=K)
    want = ref.generate(prompts, 14, prefix_emb=jnp.asarray(fr))
    assert port.generate(prompts, 14, prefix_emb=fr) == want
    assert stats(port) == stats(ref)


def test_serve_cli_needs_frames():
    """The reference's CLI gives Whisper no frames and fails inside its
    encoder (AttributeError on None); the port's says so at the CLI. With
    --scheduler continuous the engine refuses first."""
    with pytest.raises(ValueError, match="no frame embeddings"):
        tserve.main(["--arch", ARCH, "--reduced", "--d-model", "64",
                     "--device", "cpu", "--batch", "2", "--prompt-len", "8",
                     "--new-tokens", "4"])
    with pytest.raises(NotImplementedError,
                       match="family 'encdec' has no paged serving path"):
        tserve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                     "--scheduler", "continuous"])
