"""The Mamba-2 block (SSD) and the pure Mamba-2 LM on the port's static
engine, against the reference on the CPU.

mamba2-130m reduced (4 layers, d_model 64: 8 SSM heads of 16, state 16,
chunk 16), in f32 with the reference's weights. ``_ssd_chunked`` directly
at lengths that are not a multiple of the chunk (y and the final state),
one block's ``mamba_forward`` (with its decode state) and
``mamba_decode``, the LM's ``forward``, ``prefill`` and ``decode_step``
(logits and states), teacher-forced decode against the forward, and
``ServeEngine(scheduler="static")`` token- and counter-identical to the
reference's (``generate`` native and int8, which the state ignores,
``serve_bucketed``). The gates and the CLI.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.launch.serve as tserve
import repro_torch.models as tm
from repro.models import api as japi
from repro.models import ssd as jssd
from repro_torch.configs import get_config as tget
from repro_torch.models import lm as tlm
from repro_torch.models import mamba_lm as tmamba
from repro_torch.models import ssd as tssd
from torch_family_helpers import (CACHE_TOL, LOGIT_TOL, assert_same_layout,
                                  assert_tree_close, engines, family_model,
                                  leaves, opts, stats)
from torch_kernel_inputs import t as _t

torch.set_num_threads(2)

ARCH = "mamba2-130m"
MAX_LEN = 40


@pytest.fixture(scope="module")
def model():
    return family_model(ARCH)


def test_gates_and_layout(model):
    cfg, tcfg, jp, tp = model
    assert tm.static_supported(tget(ARCH)) is None
    assert tm.module_for(tget(ARCH)) is tmamba
    assert tm.paged_supported(tget(ARCH)) == (
        "family 'ssm' has no paged serving path")
    assert tlm.paged_supported(tget(ARCH)) == (
        "family 'ssm' is not covered by the paged KV path")
    # A_log, D and dt_bias stay f32 at any dtype, as in the reference
    bf = tm.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu", dtype="bfloat16")
    assert {k for k, v in bf["stack"].items()
            if torch.is_tensor(v) and v.dtype == torch.float32} == {
        "A_log", "D", "dt_bias"}
    own = tm.init_params(tcfg, torch.Generator().manual_seed(0), "float32",
                         "cpu")
    assert_same_layout(own, jp)


@pytest.mark.parametrize("S,ng", [(37, 1), (16, 1), (5, 2), (50, 2)])
def test_ssd_chunked_matches_reference(S, ng):
    """y and the final state of the chunked scan, chunk 16, at S on and
    off the chunk grid, with one and two B/C groups."""
    rng = np.random.default_rng(S)
    b, nh, hd, N = 2, 4, 8, 16
    x = rng.standard_normal((b, S, nh, hd), dtype=np.float32)
    dt = rng.uniform(0.01, 0.5, (b, S, nh)).astype(np.float32)
    A = -rng.uniform(0.5, 4.0, (nh,)).astype(np.float32)
    B = rng.standard_normal((b, S, ng, N), dtype=np.float32)
    C = rng.standard_normal((b, S, ng, N), dtype=np.float32)
    wy, wh = jssd._ssd_chunked(*map(jnp.asarray, (x, dt, A, B, C)), 16)
    ty, th = tssd._ssd_chunked(*map(_t, (x, dt, A, B, C)), 16)
    np.testing.assert_allclose(ty.numpy(), np.asarray(wy), **CACHE_TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(wh), **CACHE_TOL)


def test_block_forward_and_decode_match(model):
    """One block: the prompt's output and decode state (conv tail, SSM
    state), then three decode steps from that state."""
    cfg, tcfg, jp, tp = model
    jl = jax.tree_util.tree_map(lambda a: a[0], jp["stack"])
    tl = tlm._layer(tp["stack"], 0)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 21, cfg.d_model), dtype=np.float32)
    wy, wst = jssd.mamba_forward(jl, jnp.asarray(x), cfg, return_state=True)
    ty, tst = tssd.mamba_forward(tl, _t(x), tcfg, return_state=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(wy), **LOGIT_TOL)
    assert_tree_close(tst, wst, **CACHE_TOL)
    for j in range(3):
        xt = rng.standard_normal((2, cfg.d_model), dtype=np.float32)
        wy, wst = jssd.mamba_decode(jl, jnp.asarray(xt), wst, cfg)
        ty = tssd.mamba_decode(tl, _t(xt), tst, tcfg)     # tst in place
        np.testing.assert_allclose(ty.numpy(), np.asarray(wy), **LOGIT_TOL)
        assert_tree_close(tst, wst, **CACHE_TOL)


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


def test_state_does_not_grow_with_length(model):
    """The cache of an SSM is its state: the same bytes at any max_len."""
    tcfg = model[1]
    to = tm.RuntimeOptions(dtype="float32", cache_dtype="int8")

    def nbytes(n):
        c = tm.init_cache(tcfg, 4, n, to, device="cpu")
        return sum(x.numel() * x.element_size() for x in leaves(c))
    assert nbytes(16) == nbytes(32768) > 0


@pytest.mark.parametrize("kv_policy", ["native", "int8"])
def test_generate_matches_reference(model, kv_policy):
    cfg = model[0]
    prompts = np.random.default_rng(5).integers(1, cfg.vocab, size=(3, 10))
    prompts = prompts.astype(np.int32)
    ref, port = engines(model, max_len=MAX_LEN, kv_policy=kv_policy)
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
                       match="family 'ssm' has no paged serving path"):
        tserve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                     "--scheduler", "continuous"])
