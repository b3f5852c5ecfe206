"""The port's AdamW (``repro_torch.optim``) against the reference's
(``repro.optim``) on the CPU: fed the same gradients, three updates
agree to rel 1e-6 on f32 and on bf16 parameters (moments, master and
parameters); the cosine schedule and the global norm agree; and three
end-to-end ``build_train_step`` steps of the reduced llama3.2-1b twin,
port against reference from the same weights over the reference's
batches: losses to rel 1e-4, parameters to ||delta|| / ||p|| <= 1e-5 a
leaf (not elementwise: AdamW's first step is about lr * sign(g), so a
gradient near 0 whose sign flips moves its element by 2 lr)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import for_arch
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.optim import cosine_schedule as jcosine
from repro.optim import global_norm as jglobal_norm
from repro.train.loop import TrainConfig as JTrainConfig
from repro.train.loop import build_train_step as jbuild_train_step
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               cosine_schedule, global_norm)
from repro_torch.train import TrainConfig, build_train_step
from repro_torch.tree import leaves, tree_map
from torch_train_helpers import F32, TF32, batch_tensors, twin

torch.set_num_threads(2)

OCFG = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1,
            clip_norm=1.0)


def _tree(rng, scale=1.0):
    """A small params-like tree: a dict, a nested dict and a list."""
    return {"w": rng.standard_normal((5, 7)).astype(np.float32) * scale,
            "nest": {"b": rng.standard_normal((7,)).astype(np.float32)},
            "lst": [rng.standard_normal((3, 2)).astype(np.float32),
                    rng.standard_normal((4,)).astype(np.float32)]}


def _close(got, want, rtol=1e-6):
    """Leaf by leaf: max |got - want| <= rtol * max |want| (+ one ulp of
    f32 at that scale)."""
    g, w = leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        a = a.float().numpy()
        b = np.asarray(b, np.float32)
        scale = float(np.abs(b).max())
        assert float(np.abs(a - b).max()) <= rtol * scale + 1e-12, scale


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(dtype):
    rng = np.random.default_rng(0)
    jdt = jnp.dtype(dtype)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), _tree(rng))
    tp = tree_map(lambda a: torch.tensor(np.asarray(a, np.float32))
                  .to(getattr(torch, dtype)), jax.tree_util.tree_map(
                      np.asarray, jp))
    js, ts = jadamw_init(jp), adamw_init(tp)
    jcfg, tcfg = JAdamWConfig(**OCFG), AdamWConfig(**OCFG)
    for step in range(3):
        # gradients of a few scales, so the clip is off and on
        g = _tree(rng, scale=[0.01, 3.0, 0.3][step])
        jg = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), g)
        tg = tree_map(lambda a: torch.tensor(np.asarray(a, np.float32))
                      .to(getattr(torch, dtype)),
                      jax.tree_util.tree_map(np.asarray, jg))
        jp, js, jm = jadamw_update(jcfg, jp, jg, js)
        tp, ts, tm_ = adamw_update(tcfg, tp, tg, ts)
        assert float(tm_["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert float(tm_["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
        assert int(ts["step"]) == int(js["step"]) == step + 1
        for name in ("m", "v", "master"):
            _close(ts[name], js[name])
        _close(tp, jp, rtol=1e-6 if dtype == "float32" else 2 ** -8)
    for p, ma in zip(leaves(tp), leaves(ts["master"])):
        assert p.dtype == getattr(torch, dtype)
        assert ma.dtype == torch.float32
        assert p.data_ptr() != ma.data_ptr()
        assert torch.equal(p, ma.to(p.dtype))     # a round trip of the master


def test_adamw_init_master_is_a_copy():
    p = {"w": torch.ones(3)}
    s = adamw_init(p)
    assert s["master"]["w"].data_ptr() != p["w"].data_ptr()
    assert s["step"].dtype == torch.int32 and s["step"].shape == ()
    p["w"].add_(1.0)
    assert torch.equal(s["master"]["w"], torch.ones(3))


@pytest.mark.parametrize("step", [0, 1, 2, 5, 10, 55, 100, 150])
def test_cosine_schedule_matches_reference(step):
    for kw in (dict(lr=1e-3, warmup_steps=10, total_steps=100),
               dict(lr=3e-4, warmup_steps=0, total_steps=8)):
        want = float(jcosine(JAdamWConfig(**kw), step))
        got = cosine_schedule(AdamWConfig(**kw), step)
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(want, rel=1e-6, abs=1e-12)
        # a 0-d step tensor gives the same
        assert float(cosine_schedule(AdamWConfig(**kw), torch.tensor(
            step, dtype=torch.int32))) == float(got)


def test_global_norm_matches_reference():
    t = _tree(np.random.default_rng(3), scale=2.0)
    want = float(jglobal_norm(jax.tree_util.tree_map(jnp.asarray, t)))
    got = global_norm(tree_map(torch.from_numpy, t))
    assert float(got) == pytest.approx(want, rel=1e-6)


def test_adamw_descends_quadratic():
    cfg = AdamWConfig(lr=0.1, warmup_steps=0, total_steps=100,
                      weight_decay=0.0, clip_norm=1e9)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = adamw_init(params)
    for _ in range(200):
        params, state, _ = adamw_update(cfg, params, {"w": 2 * params["w"]},
                                        state)
    assert float(params["w"].abs().max()) < 0.3


@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_steps_match_reference(n_micro):
    """Three ``build_train_step`` steps of the reduced llama3.2-1b twin
    from the reference's weights over the reference's batches."""
    cfg, tcfg, jp, tp = twin("llama3.2-1b")
    kw = dict(steps=3, seq_len=16, global_batch=4, n_micro=n_micro)
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=3)
    jstep = jbuild_train_step(cfg, F32, JTrainConfig(
        **kw, optimizer=JAdamWConfig(**ocfg)))
    tstep = build_train_step(tcfg, TF32, TrainConfig(
        **kw, optimizer=AdamWConfig(**ocfg)))
    js = jadamw_init(jp)
    jp = jax.tree_util.tree_map(jnp.copy, jp)     # the step donates them
    ts = adamw_init(tp)
    ds = for_arch(cfg, 16, 4, seed=5)
    for s in range(3):
        b = ds.batch_at(s)
        jl, jp, js, _ = jstep(jp, js, b)
        tl, tp, ts, _ = tstep(tp, ts, batch_tensors(
            jax.tree_util.tree_map(np.asarray, b)))
        assert float(tl) == pytest.approx(float(jl), rel=1e-4)
    for a, b in zip(leaves(tp), jax.tree_util.tree_leaves(jp)):
        b = np.asarray(b)
        assert (np.linalg.norm(a.numpy() - b)
                <= 1e-5 * np.linalg.norm(b)), a.shape
