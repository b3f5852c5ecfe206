"""The port's checkpoint store (``repro_torch.checkpoint``) on the CPU:
round trip and ``keep`` GC, a partial write that stays invisible, bf16
bits that survive, the async writer, restore onto a device asked for,
and the reference's on-disk format in both directions: a JAX
``save_checkpoint`` of (params, adamw_init(params)) restores into the
port bitwise, and the port's restores through
``repro.checkpoint.restore_checkpoint`` bitwise."""
import functools
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.models as tm
from repro.checkpoint import restore_checkpoint as jrestore
from repro.checkpoint import save_checkpoint as jsave
from repro.configs import get_config
from repro.configs.reduce import reduced
from repro.models import RuntimeOptions
from repro.models import api as japi
from repro.optim import adamw_init as jadamw_init
from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.optim import adamw_init
from repro_torch.tree import leaves, tree_map

torch.set_num_threads(2)


def _tree():
    g = torch.Generator().manual_seed(0)
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "nest": {"b": torch.randn(4, generator=g).to(torch.bfloat16)},
            "lst": [torch.zeros(2), torch.full((2,), 7.0)],
            "step": torch.tensor(3, dtype=torch.int32)}


def _bits(t):
    """The tensor's bytes, to compare bitwise."""
    t = t.detach().cpu().contiguous()
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(_bits(a), _bits(b))


def test_roundtrip_and_gc(tmp_path):
    tree = _tree()
    for s in (5, 10, 15, 20):
        save_checkpoint(tmp_path, s, tree, keep=2)
    assert latest_step(tmp_path) == 20
    steps = sorted(int(p.name.split("_")[1])
                   for p in pathlib.Path(tmp_path).glob("step_*"))
    assert steps == [15, 20]
    got, step = restore_checkpoint(tmp_path, tree)
    assert step == 20
    assert list(got) == list(tree) and isinstance(got["lst"], list)
    for a, b in zip(leaves(got), leaves(tree)):
        _same(a, b)
    got, step = restore_checkpoint(tmp_path, tree, step=15)
    assert step == 15
    m = json.loads((tmp_path / "step_20" / "manifest.json").read_text())
    assert m["step"] == 20
    assert m["keys"] == sorted(["a", "nest__b", "lst__0", "lst__1", "step"])
    assert m["dtypes"]["nest__b"] == "bfloat16"
    assert m["shapes"]["a"] == [2, 3] and m["shapes"]["step"] == []


def test_partial_write_is_invisible(tmp_path):
    save_checkpoint(tmp_path, 1, {"a": torch.ones(2)})
    (pathlib.Path(tmp_path) / "step_9.tmp").mkdir()
    (pathlib.Path(tmp_path) / "step_7").mkdir()          # no manifest yet
    assert latest_step(tmp_path) == 1
    assert latest_step(tmp_path / "absent") is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(tmp_path / "absent", {"a": torch.ones(2)})


def test_bf16_bits_survive(tmp_path):
    """Every bf16 bit pattern (NaNs, infinities, subnormals and -0
    included) comes back as it went."""
    bits = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(torch.int16)
    t = {"x": bits.view(torch.bfloat16)}
    save_checkpoint(tmp_path, 1, t)
    got, _ = restore_checkpoint(tmp_path, t)
    assert torch.equal(got["x"].view(torch.int16), bits)
    raw = np.load(tmp_path / "step_1" / "leaves.npz")["x"]
    assert raw.dtype == np.uint16


def test_async_write_and_casts(tmp_path):
    tree = _tree()
    th = save_checkpoint(tmp_path, 2, tree, block=False)
    tree["a"].add_(100.0)               # the host copy was taken first
    th.join()
    like = dict(tree, a=torch.zeros((2, 3), dtype=torch.float64))
    got, _ = restore_checkpoint(tmp_path, like, device="cpu")
    assert got["a"].dtype == torch.float64
    assert torch.equal(got["a"], torch.arange(6, dtype=torch.float64)
                       .reshape(2, 3))


def test_missing_leaf_raises(tmp_path):
    save_checkpoint(tmp_path, 1, {"a": torch.ones(2)})
    with pytest.raises(ValueError, match="missing leaves"):
        restore_checkpoint(tmp_path, {"a": torch.ones(2),
                                      "b": torch.ones(1)})


@functools.lru_cache(maxsize=None)
def _jax_state(dtype):
    cfg = reduced(get_config("deepseek-v2-236b"), d_model=64, vocab=128,
                  n_layers=2)
    jp = jax.jit(lambda k: japi.init_params(
        cfg, k, RuntimeOptions(dtype=dtype)))(jax.random.PRNGKey(1))
    js = jadamw_init(jp)
    # a state that is not all zeros
    js = dict(js, step=jnp.int32(7),
              m=jax.tree_util.tree_map(lambda x: x + 0.25, js["m"]))
    return cfg, jp, js


def _port_like(jp, dtype):
    tp = tm.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu", dtype=dtype)
    return tp, adamw_init(tp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_checkpoint_restores_into_port(tmp_path, dtype):
    """deepseek-v2's twin (a list of head layers, a stacked MoE subtree,
    f32 router leaves among bf16 ones) and its AdamW state."""
    cfg, jp, js = _jax_state(dtype)
    jsave(tmp_path, 7, (jp, js))
    like = _port_like(jp, dtype)
    (tp, ts), step = restore_checkpoint(tmp_path, like)
    assert step == 7 and int(ts["step"]) == 7
    want = jax.tree_util.tree_leaves((jp, js))
    got = leaves((tp, ts))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert str(a.dtype).split(".")[1] == b.dtype.name
        if b.dtype.name == "bfloat16":
            assert np.array_equal(a.view(torch.int16).numpy(),
                                  b.view(np.int16))
        else:
            assert np.array_equal(a.numpy(), b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_checkpoint_restores_into_jax(tmp_path, dtype):
    cfg, jp, js = _jax_state(dtype)
    tp, ts = _port_like(jp, dtype)
    ts["step"] = torch.tensor(4, dtype=torch.int32)
    ts["v"] = tree_map(lambda x: x + 0.5, ts["v"])
    save_checkpoint(tmp_path, 4, (tp, ts))
    (rp, rs), step = jrestore(tmp_path, (jp, js))
    assert step == 4 and int(rs["step"]) == 4
    got = jax.tree_util.tree_leaves((rp, rs))
    want = leaves((tp, ts))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a = np.asarray(a)
        if b.dtype == torch.bfloat16:
            assert a.dtype.name == "bfloat16"
            assert np.array_equal(a.view(np.int16),
                                  b.view(torch.int16).numpy())
        else:
            assert np.array_equal(a, b.numpy())
