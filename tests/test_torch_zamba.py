"""The Zamba2 hybrid (Mamba-2 backbone, one shared attention + MLP block
every ``attn_every`` blocks) on the port's static engine, against the
reference on the CPU.

zamba2-2.7b reduced (4 Mamba-2 blocks, 2 shared-attention sites, d_model
64, 4 heads of 16), in f32 with the reference's weights: the shared block,
``forward``, ``prefill`` and ``decode_step`` (logits, every state and each
site's KV), teacher-forced decode against the forward, and
``ServeEngine(scheduler="static")`` token- and counter-identical to the
reference's (``generate``, ``serve_bucketed``). An int8 KV cache raises
(the reference casts the unscaled KV to int8). The gates, the routes (the
masked attention once a site, no kernel entry) and the CLI.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.launch.serve as tserve
import repro_torch.models as tm
from repro.models import api as japi
from repro.models import zamba as jzamba
from repro_torch.configs import get_config as tget
from repro_torch.models import common as tcm
from repro_torch.models import zamba as tzamba
from repro_torch.serving import ServeEngine
from torch_family_helpers import (CACHE_TOL, LOGIT_TOL, assert_same_layout,
                                  assert_tree_close, engines, family_model,
                                  opts, stats)
from torch_kernel_inputs import t as _t

torch.set_num_threads(2)

ARCH = "zamba2-2.7b"
MAX_LEN = 40


@pytest.fixture(scope="module")
def model():
    return family_model(ARCH)


def test_gates_and_layout(model):
    cfg, tcfg, jp, tp = model
    assert tm.static_supported(tget(ARCH)) is None
    assert tm.module_for(tget(ARCH)) is tzamba
    assert tm.paged_supported(tget(ARCH)) == (
        "family 'hybrid' has no paged serving path")
    assert tzamba._layout(tget(ARCH)) == (9, 6)
    assert tp["mamba"]["A_log"].shape[:2] == (2, 2)
    own = tm.init_params(tcfg, torch.Generator().manual_seed(0), "float32",
                         "cpu")
    assert_same_layout(own, jp)


def test_shared_block_matches(model):
    cfg, tcfg, jp, tp = model
    jo, _ = opts()
    rng = np.random.default_rng(6)
    x, e0 = (rng.standard_normal((2, 11, cfg.d_model), dtype=np.float32)
             for _ in range(2))
    pos = np.broadcast_to(np.arange(11)[None], (2, 11))
    wd, (wk, wv) = jzamba._shared_block(jp["shared"], jnp.asarray(x),
                                        jnp.asarray(e0), cfg, jo,
                                        positions=jnp.asarray(pos))
    td, (tk_, tv) = tzamba._shared_block(tp["shared"], _t(x), _t(e0), tcfg,
                                         _t(pos))
    np.testing.assert_allclose(td.numpy(), np.asarray(wd), **LOGIT_TOL)
    np.testing.assert_allclose(tk_.numpy(), np.asarray(wk), **CACHE_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(wv), **CACHE_TOL)


def test_forward_prefill_decode_match(model):
    cfg, tcfg, jp, tp = model
    jo, to = opts()
    B, S, Lmax = 2, 21, 26
    toks = np.random.default_rng(2).integers(1, cfg.vocab, size=(B, S))
    toks = toks.astype(np.int32)
    want, _ = japi.forward(cfg, jp, jnp.asarray(toks), jo)
    got = tm.forward(tcfg, tp, _t(toks), to)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    jc = japi.init_cache(cfg, B, Lmax, jo)
    tc = tm.init_cache(tcfg, B, Lmax, to, device="cpu")
    jl, jc = japi.prefill(cfg, jp, jnp.asarray(toks), jc, jo)
    tl, tc = tm.prefill(tcfg, tp, _t(toks), tc, to)
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


def test_decode_matches_forward(model):
    _, tcfg, _, tp = model
    to = tm.RuntimeOptions(dtype="float32")
    toks = _t(np.random.default_rng(3).integers(1, tcfg.vocab, size=(2, 24))
              .astype(np.int32))
    full = tm.forward(tcfg, tp, toks, to)
    cache = tm.init_cache(tcfg, 2, 24, to, device="cpu")
    lg, cache = tm.prefill(tcfg, tp, toks[:, :19], cache, to)
    errs = [float((lg - full[:, 18]).abs().max())]
    for t in range(19, 24):
        lg, cache = tm.decode_step(tcfg, tp, toks[:, t], t, cache, to)
        errs.append(float((lg - full[:, t]).abs().max()))
    assert max(errs) < 1e-4, errs


def test_masked_attention_once_a_site(model):
    _, tcfg, _, tp = model
    to = tm.RuntimeOptions(dtype="float32")
    cache = tm.init_cache(tcfg, 1, 16, to, device="cpu")
    n0 = tcm.attention.calls
    tm.prefill(tcfg, tp, torch.ones((1, 12), dtype=torch.int32), cache, to)
    tm.decode_step(tcfg, tp, torch.ones((1,), dtype=torch.int32), 12, cache,
                   to)
    assert tcm.attention.calls - n0 == 2 * tzamba._layout(tcfg)[0]


def test_int8_cache_raises_naming_roadmap(model):
    tcfg = model[1]
    to = tm.RuntimeOptions(dtype="float32", cache_dtype="int8")
    with pytest.raises(NotImplementedError,
                       match=r"zamba\.py:123.*ROADMAP\.md queue C"):
        tm.init_cache(tcfg, 1, 16, to, device="cpu")
    eng = ServeEngine(tcfg, model[3], tm.RuntimeOptions(dtype="float32"),
                      device="cpu", scheduler="static", kv_policy="int8",
                      max_len=MAX_LEN)
    with pytest.raises(NotImplementedError, match="unscaled KV"):
        eng.generate(np.ones((1, 4), np.int32), 2)


@pytest.mark.parametrize("K", [1, 8])
def test_generate_matches_reference(model, K):
    cfg = model[0]
    prompts = np.random.default_rng(5).integers(1, cfg.vocab, size=(3, 10))
    prompts = prompts.astype(np.int32)
    ref, port = engines(model, max_len=MAX_LEN, K=K)
    want = ref.generate(prompts, 14)
    assert port.generate(prompts, 14) == want
    assert stats(port) == stats(ref)


def test_serve_bucketed_matches_reference(model):
    cfg = model[0]
    rng = np.random.default_rng(3)
    reqs = [rng.integers(1, cfg.vocab, size=n).tolist()
            for n in (5, 17, 5, 17, 17)]
    ref, port = engines(model, max_len=MAX_LEN)
    want = ref.serve([r[:] for r in reqs], 9)
    assert port.serve([r[:] for r in reqs], 9) == want
    assert stats(port) == stats(ref)


def test_serve_cli_static_and_continuous_refusal(capsys):
    tserve.main(["--arch", ARCH, "--reduced", "--d-model", "64", "--device",
                 "cpu", "--batch", "2", "--prompt-len", "8",
                 "--new-tokens", "4"])
    out = capsys.readouterr().out
    assert f"[serve] arch={ARCH} device=cpu sched=static" in out
    with pytest.raises(NotImplementedError,
                       match="family 'hybrid' has no paged serving path"):
        tserve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                     "--scheduler", "continuous"])
