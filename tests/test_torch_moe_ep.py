"""Shard-local expert-parallel MoE of the port (``moe_ffn(impl=
"shard_map")``) on real ranks: N = 1, 2, 4 gloo ranks spawned on the CPU,
each holding E/N of the experts (``init_params(experts=)``), on reduced
arctic-480b (dense residual) and reduced deepseek-v2 (shared experts),
E = 8, top-2. Held against the port's capacity path at the same capacity
factor (both route every token identically: with drops at 1.25, none at
8.0) and against the reference's ``_shard_map_path`` under ``shard_map``
on a (1, N) Auto-axis mesh of host devices (a subprocess:
``torch_ref_mesh.py``). f32; outputs and aux losses within 2e-4 (the
reference's bound in ``tests/test_perf_paths.py``)."""
import json
import os
import pathlib
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.configs.reduce import reduced
from repro.models import moe as jmoe
import repro_torch.models as tm
from repro_torch.configs import get_config as tget
from repro_torch.configs.reduce import reduced as treduced
from repro_torch.launch.ranks import run_ranks
from repro_torch.models import moe as tmoe

import torch_ep_ranks as ranks
from torch_ep_ranks import expert_slice

torch.set_num_threads(2)

HERE = pathlib.Path(__file__).resolve().parent
ARCHS = ["arctic-480b", "deepseek-v2-236b"]
NS = (1, 2, 4)
CFS = (1.25, 8.0)
TOL = dict(atol=2e-4, rtol=2e-4)


def _x(arch):
    rng = np.random.default_rng(len(arch))
    x = rng.standard_normal((2, 12, 64), dtype=np.float32)
    return x + rng.standard_normal(64, dtype=np.float32)


@pytest.fixture(scope="module")
def setup():
    """arch -> (port config, numpy MoE weights of the reference's
    init_moe at key 0)."""
    out = {}
    for arch in ARCHS:
        cfg = reduced(get_config(arch), d_model=64, vocab=128)
        jp = jmoe.init_moe(jax.random.PRNGKey(0), cfg, jnp.float32)
        out[arch] = (treduced(tget(arch), d_model=64, vocab=128),
                     jax.tree_util.tree_map(np.asarray, jp))
    return out


@pytest.fixture(scope="module")
def reference(setup):
    """The reference's shard_map (y, aux) of every (arch, N, cf)."""
    tasks, keys = [], []
    for arch in ARCHS:
        for n in NS:
            for cf in CFS:
                tasks.append({"task": "moe", "arch": arch, "n": n,
                              "capacity_factor": cf})
                keys.append((arch, n, cf))
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, PYTHONPATH=str(HERE.parent / "src"))
        # one subprocess per arch: the task reads its x from "x"
        for arch in ARCHS:
            sub = [t for t in tasks if t["arch"] == arch]
            jf = pathlib.Path(tmp, f"{arch}.json")
            of = pathlib.Path(tmp, f"{arch}.out.json")
            af = pathlib.Path(tmp, f"{arch}.npz")
            jf.write_text(json.dumps(sub))
            np.savez(af, x=_x(arch))
            subprocess.run([sys.executable, str(HERE / "torch_ref_mesh.py"),
                            str(jf), str(of), str(af)], check=True,
                           timeout=300, env=env)
            npz = dict(np.load(str(of) + ".npz"))
            for i, t in enumerate(sub):
                out[arch, t["n"], t["capacity_factor"]] = (
                    npz[f"{i}.y"], npz[f"{i}.aux"])
    return out


@pytest.fixture(scope="module", params=NS)
def port(request, setup):
    """The port's EP (y, aux) on each rank for every (arch, cf), from one
    spawned group of N ranks."""
    n = request.param
    cases = [(setup[a][0], setup[a][1], _x(a), cf) for a in ARCHS
             for cf in CFS]
    res = run_ranks(ranks.moe_ep, n, (n, cases), timeout=120.0)
    keys = [(a, cf) for a in ARCHS for cf in CFS]
    return n, {k: [r[i] for r in res] for i, k in enumerate(keys)}


def _capacity(setup, arch, cf):
    cfg, np_params = setup[arch]
    p = tm.params_from_numpy(np_params, device="cpu")
    y, aux = tmoe.moe_ffn(p, torch.from_numpy(_x(arch)), cfg,
                          capacity_factor=cf)
    return y.numpy(), np.array([float(aux["load_balance"]),
                                float(aux["router_z"])])


@pytest.mark.parametrize("cf", CFS)
@pytest.mark.parametrize("arch", ARCHS)
def test_ep_matches_capacity_path_and_reference(setup, reference, port,
                                                arch, cf):
    n, got = port
    cap_y, cap_aux = _capacity(setup, arch, cf)
    ref_y, ref_aux = reference[arch, n, cf]
    assert float(np.abs(cap_y).max()) > 0
    for y, aux in got[arch, cf]:
        np.testing.assert_allclose(y, cap_y, **TOL)
        np.testing.assert_allclose(aux, cap_aux, **TOL)
        np.testing.assert_allclose(y, ref_y, **TOL)
        np.testing.assert_allclose(aux, ref_aux, **TOL)


def test_shard_map_needs_a_group_and_the_expert_block(setup):
    """impl="shard_map" without ranks raises ValueError (no fallback to
    the capacity path), an unknown impl too, and a rank holding every
    expert is refused."""
    from repro_torch.kernels.sharded import ShardGroup
    cfg, np_params = setup["arctic-480b"]
    p = tm.params_from_numpy(np_params, device="cpu")
    x = torch.from_numpy(_x("arctic-480b"))
    with pytest.raises(ValueError, match="shard_map_mesh"):
        tmoe.moe_ffn(p, x, cfg, impl="shard_map")
    with pytest.raises(ValueError, match="impl"):
        tmoe.moe_ffn(p, x, cfg, impl="dense")
    g = ShardGroup(None, 0, 2, torch.device("cpu"))
    with pytest.raises(ValueError, match="experts="):
        tmoe.moe_ffn(p, x, cfg, impl="shard_map", shard_map_mesh=g)
    cut = expert_slice(p, g)
    assert cut["w_up"].shape[0] == p["w_up"].shape[0] // 2
    assert torch.equal(cut["w_down"], p["w_down"][:p["w_down"].shape[0] // 2])
    stacked = expert_slice({"stack": {"moe": {"w_up": torch.zeros(
        3, 8, 4, 6)}}}, ShardGroup(None, 1, 4, torch.device("cpu")))
    assert stacked["stack"]["moe"]["w_up"].shape == (3, 2, 4, 6)


@pytest.mark.parametrize("rank", range(4))
def test_init_of_an_expert_slice_is_that_slice_of_the_whole_init(rank):
    """``init_params(experts=slice)`` (what an EP rank holds) draws every
    expert from the same stream and keeps its slice: bitwise the slice of
    the whole init; every other leaf equal."""
    from repro_torch.kernels.sharded import ShardGroup
    cfg = treduced(tget("arctic-480b"), d_model=64, vocab=128)
    whole = tm.init_params(cfg, torch.Generator().manual_seed(0), "float32",
                           "cpu")
    part = tm.init_params(cfg, torch.Generator().manual_seed(0), "float32",
                          "cpu", experts=slice(2 * rank, 2 * rank + 2))
    want = expert_slice(whole, ShardGroup(None, rank, 4,
                                               torch.device("cpu")))
    from repro_torch.tree import items
    got, ref = dict(items(part)), dict(items(want))
    assert got.keys() == ref.keys()
    for k in got:
        assert torch.equal(got[k], ref[k]), k
