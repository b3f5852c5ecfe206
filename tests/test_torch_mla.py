"""Multi-head latent attention (DeepSeek-V2) with its dense first layer
before the MoE stack, on the port's static engine, against the reference
on the CPU.

deepseek-v2-236b reduced to 1 dense + 2 MoE layers (d_model 64, 8 experts
top-2 and a shared one, the MLA ranks of ``configs/reduce.py``), in f32
with the reference's weights: ``forward`` (logits and each layer's latent
and rope key), ``prefill`` and ``decode_step`` (logits and the latent
cache, with and without ``cache_dtype="int8"``, which MLA ignores),
teacher-forced decode against the forward, and ``ServeEngine(scheduler=
"static")`` token- and counter-identical to the reference's (``generate``
native and int8, ``serve_bucketed``). The gates, the routes (every MLA
attention is the masked attention, no kernel entry), and the CLI.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.kernels.decode_attention as tk
import repro_torch.kernels.flash_attention as tkf
import repro_torch.launch.serve as tserve
import repro_torch.models as tm
from repro.models import api as japi
from repro_torch.configs import get_config as tget
from repro_torch.models import common as tcm
from repro_torch.models import lm as tlm
from torch_family_helpers import (CACHE_TOL, LOGIT_TOL, assert_same_layout,
                                  assert_tree_close, engines, family_model,
                                  opts, stats)
from torch_kernel_inputs import t as _t

torch.set_num_threads(2)

ARCH = "deepseek-v2-236b"
MAX_LEN = 40


@pytest.fixture(scope="module")
def model():
    return family_model(ARCH, n_layers=3)


def test_gates_and_layout(model):
    cfg, tcfg, jp, tp = model
    assert tm.static_supported(tget(ARCH)) is None
    assert tm.module_for(tget(ARCH)) is tlm
    assert tm.paged_supported(tget(ARCH)) == (
        "MLA latent cache is already compressed; paged path covers GQA")
    no_mla = dataclasses.replace(tget(ARCH), mla=None)
    assert tlm.paged_supported(no_mla) == (
        "unscanned prefix layers not supported by the paged cache")
    # one dense head layer (d_ff_dense) before a 2-layer MoE stack
    assert len(tp["head_layers"]) == 1 and "mlp" in tp["head_layers"][0]
    assert tp["stack"]["moe"]["w_up"].shape[0] == 2
    own = tm.init_params(tcfg, torch.Generator().manual_seed(0), "float32",
                         "cpu")
    assert_same_layout(own, jp)


def test_forward_collect_kv_matches(model):
    cfg, tcfg, jp, tp = model
    jo, to = opts()
    toks = np.random.default_rng(1).integers(1, cfg.vocab, size=(2, 13))
    toks = toks.astype(np.int32)
    jl, _, (jhead, (jc, jkr)) = japi.module_for(cfg).forward(
        cfg, jp, jnp.asarray(toks), jo, collect_kv=True)
    tl, kvs = tm.forward(tcfg, tp, _t(toks), to, collect_kv=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    want = [tuple(np.asarray(a) for a in kv) for kv in jhead]
    want += [(np.asarray(jc[i]), np.asarray(jkr[i]))
             for i in range(jc.shape[0])]
    assert len(kvs) == len(want) == 3
    for (c, kr), (wc, wkr) in zip(kvs, want):
        assert c.shape[-1] == cfg.mla.kv_lora_rank
        np.testing.assert_allclose(c.numpy(), wc, **CACHE_TOL)
        np.testing.assert_allclose(kr.numpy(), wkr, **CACHE_TOL)


@pytest.mark.parametrize("cache_dtype", ["", "int8"])
def test_prefill_and_decode_match(model, cache_dtype):
    """Logits and the latent caches (head and stack) after the prefill and
    after each decode step; int8 leaves the latent cache native, as in the
    reference."""
    cfg, tcfg, jp, tp = model
    jo, to = opts(cache_dtype)
    B, S, Lmax = 2, 9, 14
    toks = np.random.default_rng(2).integers(1, cfg.vocab, size=(B, S))
    toks = toks.astype(np.int32)
    jc = japi.init_cache(cfg, B, Lmax, jo)
    tc = tm.init_cache(tcfg, B, Lmax, to, device="cpu")
    assert all(x.dtype == torch.float32 for x in
               [tc["stack"]["c"], tc["head"][0]["k_rope"]])
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
    """Teacher-forced absorbed decode == the decompressed forward (no
    replica drops at capacity factor 8), as the reference's
    ``test_decode_matches_forward``."""
    _, tcfg, _, tp = model
    to = tm.RuntimeOptions(dtype="float32", capacity_factor=8.0)
    toks = _t(np.random.default_rng(3).integers(1, tcfg.vocab, size=(2, 10))
              .astype(np.int32))
    full = tm.forward(tcfg, tp, toks, to)
    cache = tm.init_cache(tcfg, 2, 10, to, device="cpu")
    lg, cache = tm.prefill(tcfg, tp, toks[:, :6], cache, to)
    errs = [float((lg - full[:, 5]).abs().max())]
    for t in range(6, 10):
        lg, cache = tm.decode_step(tcfg, tp, toks[:, t], t, cache, to)
        errs.append(float((lg - full[:, t]).abs().max()))
    assert max(errs) < 1e-4, errs


def test_routes_are_the_masked_attention(monkeypatch, model):
    """The prompt attends at head width 192-equivalent (nope + rope) through
    the masked attention, once a layer; decode is absorbed (no attention
    entry at all); no kernel entry's plain version runs."""
    _, tcfg, _, tp = model
    calls = []
    for mod, name in ((tkf, "flash_attention_plain"),
                      (tk, "decode_attention_plain")):
        monkeypatch.setattr(mod, name,
                            lambda *a, _n=name, **k: calls.append(_n))
    to = tm.RuntimeOptions(dtype="float32")
    cache = tm.init_cache(tcfg, 1, 16, to, device="cpu")
    n0 = tcm.attention.calls
    tm.prefill(tcfg, tp, torch.ones((1, 12), dtype=torch.int32), cache, to)
    assert tcm.attention.calls - n0 == tcfg.n_layers
    n0 = tcm.attention.calls
    tm.decode_step(tcfg, tp, torch.ones((1,), dtype=torch.int32), 12, cache,
                   to)
    assert tcm.attention.calls == n0 and not calls


@pytest.mark.parametrize("kv_policy", ["native", "int8"])
def test_generate_matches_reference(model, kv_policy):
    cfg = model[0]
    prompts = np.random.default_rng(5).integers(1, cfg.vocab, size=(3, 10))
    prompts = prompts.astype(np.int32)
    ref, port = engines(model, max_len=MAX_LEN, kv_policy=kv_policy)
    want = ref.generate(prompts, 14)
    assert port.generate(prompts, 14) == want
    assert stats(port) == stats(ref)
    if kv_policy == "int8":     # the latent cache stays native
        _, native = engines(model, max_len=MAX_LEN)
        assert native.generate(prompts, 14) == want


def test_serve_bucketed_matches_reference(model):
    cfg = model[0]
    rng = np.random.default_rng(3)
    reqs = [rng.integers(1, cfg.vocab, size=n).tolist()
            for n in (5, 12, 5, 12)]
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
    with pytest.raises(NotImplementedError, match="MLA latent cache"):
        tserve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                     "--scheduler", "continuous"])
