"""The port's ``train_loss`` and its gradients against the reference's
(``jax.value_and_grad`` of ``repro.models.train_loss``) on the CPU, in
f32, on the reduced twin of every family: the dense decoder
(llama3.2-1b), the MoE stack with its aux losses (arctic-480b), the VLMs
with their ``prefix_emb`` (llava15-13b causal, paligemma-3b prefix-LM),
the soft-capped local:global decoder (gemma3-1b), MLA with its dense
prefix layer (deepseek-v2-236b), Mamba-2, Zamba2 and Whisper. Weights are
the reference's (``params_from_numpy``), batches the reference pipeline's.
Also: remat "block" == "none", the gradients of ``n_micro`` 2 == 1, and
the training route (the masked attention on every layer, no kernel entry,
whatever the device would take)."""
import numpy as np
import pytest
import torch

import repro_torch.kernels.decode_attention as tk
import repro_torch.kernels.flash_attention as tkf
import repro_torch.models as tm
from repro.data.pipeline import for_arch
from repro_torch.models import common as tcm
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.train import TrainConfig, build_train_step
from repro_torch.tree import tree_map
from torch_train_helpers import (LOSS_RTOL, TF32, assert_grads_close,
                                 batch_tensors, port_grads, reference)

torch.set_num_threads(2)

FAMILIES = {"llama3.2-1b": {}, "arctic-480b": {}, "llava15-13b": {},
            "paligemma-3b": {}, "gemma3-1b": {},
            "deepseek-v2-236b": dict(n_layers=2), "mamba2-130m": {},
            "zamba2-2.7b": {}, "whisper-medium": {}}


def _ref(arch):
    return reference(arch, **FAMILIES[arch])


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_train_loss_matches_reference(arch):
    (cfg, tcfg, _, tp), jb, want, want_aux, _ = _ref(arch)
    with torch.no_grad():
        loss, aux = tm.train_loss(tcfg, tp, batch_tensors(jb), TF32)
    assert abs(float(loss) - want) <= LOSS_RTOL * abs(want)
    assert set(aux) == set(want_aux)
    for k, v in want_aux.items():
        assert abs(float(aux[k]) - v) <= LOSS_RTOL * max(abs(v), 1e-6), k


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_train_grads_match_reference(arch):
    (cfg, tcfg, _, tp), jb, want, _, want_g = _ref(arch)
    loss, _, g = port_grads(tcfg, tp, batch_tensors(jb))
    assert abs(float(loss) - want) <= LOSS_RTOL * abs(want)
    assert_grads_close(g, want_g)
    assert all(bool(torch.isfinite(x).all()) for x in g)


def test_moe_aux_in_the_total():
    """arctic's total is nll + 0.01 load_balance + 1e-4 router_z, and the
    aux losses carry gradient into the router."""
    (cfg, tcfg, _, tp), jb, want, aux, want_g = _ref("arctic-480b")
    assert want == pytest.approx(aux["nll"] + 0.01 * aux["load_balance"]
                                 + 1e-4 * aux["router_z"], rel=1e-6)
    with torch.no_grad():
        loss, taux = tm.train_loss(tcfg, tp, batch_tensors(jb), TF32)
    assert float(loss) != pytest.approx(float(taux["nll"]), rel=1e-6)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "arctic-480b",
                                  "deepseek-v2-236b", "mamba2-130m",
                                  "zamba2-2.7b"])
def test_remat_block_equals_none(arch):
    """Activation checkpointing recomputes the same function: loss and
    every gradient leaf as without it, and as the reference's."""
    (cfg, tcfg, _, tp), jb, want, _, want_g = _ref(arch)
    b = batch_tensors(jb)
    l0, _, g0 = port_grads(tcfg, tp, b)
    l1, _, g1 = port_grads(tcfg, tp, b, tm.RuntimeOptions(dtype="float32",
                                                          remat="block"))
    assert abs(float(l1) - float(l0)) <= LOSS_RTOL * abs(float(l0))
    assert_grads_close(g1, [x.numpy() for x in g0])
    assert_grads_close(g1, want_g)


def test_remat_rejects_unknown():
    (cfg, tcfg, _, tp), jb, *_ = _ref("llama3.2-1b")
    with pytest.raises(ValueError, match="remat"):
        tm.train_loss(tcfg, tp, batch_tensors(jb),
                      tm.RuntimeOptions(dtype="float32", remat="full"))


def _steps(cfg, tcfg, tp, n_micro, steps=3):
    """The losses of ``steps`` AdamW steps from ``tp`` over the reference
    pipeline's batches of 4 x 16 (seed 2)."""
    tc = TrainConfig(steps=steps, seq_len=16, global_batch=4,
                     n_micro=n_micro,
                     optimizer=AdamWConfig(lr=1e-3, warmup_steps=0,
                                           total_steps=steps))
    step = build_train_step(tcfg, TF32, tc)
    params = tree_map(torch.clone, tp)
    state = adamw_init(params)
    ds = for_arch(cfg, 16, 4, seed=2)
    losses = []
    for s in range(steps):
        loss, params, state, _ = step(params, state,
                                      batch_tensors(ds.batch_at(s)))
        losses.append(float(loss))
    return losses


def test_grad_accumulation_matches_single_batch():
    """n_micro=2 == n_micro=1 over three steps to the reference's own
    tolerance (rel 2e-3 on the losses), and the first step's loss equal to
    the f32 rounding."""
    (cfg, tcfg, _, tp), *_ = _ref("llama3.2-1b")
    l1 = _steps(cfg, tcfg, tp, 1)
    l2 = _steps(cfg, tcfg, tp, 2)
    np.testing.assert_allclose(l2, l1, rtol=2e-3)
    assert l2[0] == pytest.approx(l1[0], rel=1e-6)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "llava15-13b"])
def test_training_route_takes_masked_attention(arch, monkeypatch):
    """Every prompt attention of the training forward is
    ``common.attention``, even on layers the static prefill gives to the
    flash kernel; no kernel entry, nor the flash kernel's plain version,
    is reached."""
    (cfg, tcfg, _, tp), jb, *_ = _ref(arch)
    entries = (tk.paged_decode_attention, tk.chunk_prefill_attention,
               tk.spec_verify_attention, tk.decode_attention,
               tkf.flash_attention)
    launches = [e.launches for e in entries]
    plain = []
    monkeypatch.setattr(tkf, "flash_attention_plain",
                        lambda *a, **k: plain.append(1))
    before = tcm.attention.calls
    port_grads(tcfg, tp, batch_tensors(jb))
    assert plain == []
    assert tcm.attention.calls - before == cfg.n_layers
    assert [e.launches for e in entries] == launches
