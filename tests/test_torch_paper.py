"""The paper's runners on the port (``repro_torch.paper``) against the
reference's (``benchmarks/``, ``examples/stco_sweep.py``): every emitted
row string for string, the H100 tiers runner under the reference's v5e
chain, and ``concurrency_sweep``'s runtime halves on the CPU at the
reference's reduced twin, token and counter for counter against the JAX
engines on the same weights."""
import contextlib
import importlib
import io
import pathlib
import runpy
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.configs.reduce import reduced
from repro.models import RuntimeOptions, init_params
from repro.serving import ServeEngine as JaxEngine
import repro_torch.models as tm
from repro_torch.core import MemoryHierarchy, MemoryLevel
from repro_torch.core.h100_roofline import h100_hierarchy
from repro_torch.core.memspec import GB, MB, US, ComputeSpec
from repro_torch.paper import beyond_gpu_tiers
from repro_torch.paper import concurrency_sweep as tcs
from repro_torch.paper import roofline_h100
from repro_torch.paper import run as trun
from repro_torch.paper import stco_sweep
from torch_copy_helpers import same_but_imports

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import benchmarks.beyond_tpu_tiers as jtiers  # noqa: E402
import benchmarks.concurrency_sweep as jcs  # noqa: E402
import benchmarks.run as jrun  # noqa: E402

torch.set_num_threads(2)

RUNNERS = ("table1", "fig1", "fig2", "fig3", "fig4")
COUNTERS = ("decode_steps", "preemptions", "peak_pages_used",
            "pages_deduped", "prefill_tokens_computed", "host_syncs")


def _rows(mod, **kw):
    rows = []
    derived = mod.run(lambda name, us, d: rows.append((name, d)), **kw)
    return rows, derived


@pytest.mark.parametrize("name", RUNNERS)
def test_runner_rows_equal_the_reference(name):
    ref = importlib.import_module(f"benchmarks.{name}")
    port = importlib.import_module(f"repro_torch.paper.{name}")
    assert _rows(port) == _rows(ref)


@pytest.mark.parametrize("name", RUNNERS)
def test_runner_is_a_copy(name):
    port = (ROOT / "src" / "repro_torch" / "paper" / f"{name}.py").read_text()
    ref = (ROOT / "benchmarks" / f"{name}.py").read_text()
    assert same_but_imports(port, ref)


def _csv(text):
    """(name, derived) of each CSV row: the time column differs by run."""
    out = []
    for line in text.splitlines()[1:]:
        name, _, derived = line.split(",", 2)
        out.append((name, derived))
    return out


def test_run_harness_prints_the_reference_rows(monkeypatch, capsys,
                                              tmp_path):
    # no dry-run records: the roofline runner's row says so
    monkeypatch.setattr(roofline_h100, "ART", tmp_path / "none")
    trun.main([])
    port = _csv(capsys.readouterr().out)
    monkeypatch.setattr(sys, "argv", ["run"])
    jrun.main()
    ref = _csv(capsys.readouterr().out)
    # table1 and fig1-4 row for row, then the H100 tiers in place of the
    # TPU's, and the dry-run table on the H100 in place of the TPU pod's
    n = len([r for r in ref if not r[0].startswith(("beyond", "roofline"))])
    assert port[:n] == ref[:n]
    assert [r[0] for r in port[n:]] == (
        [f"beyond.gpu_tiers.{r[0].split('.', 2)[2]}" for r in ref[n:-2]]
        + ["beyond_gpu_tiers.total", "roofline_h100.total"])
    assert "no dry-run records" in port[-1][1]


def test_run_harness_only(capsys):
    trun.main(["--only", "table1"])
    names = [r[0] for r in _csv(capsys.readouterr().out)]
    assert names[-1] == "table1.total" and len(names) == 5


def _v5e_serving_chain():
    """The reference's ``tpu_serving_hierarchy()``, built with the port's
    memspec."""
    chain = (
        MemoryLevel("vmem", capacity=128 * MB, bandwidth=40e12, latency=0.0),
        MemoryLevel("l2", capacity=128 * MB, bandwidth=20e12, latency=0.0),
        MemoryLevel("ddr", capacity=16 * GB, bandwidth=819e9, latency=0.4e-6),
        MemoryLevel("hbs", capacity=512 * GB, bandwidth=24.0 * GB,
                    latency=5.0 * US),
    )
    return MemoryHierarchy(compute=ComputeSpec("tpu-v5e", flops=197e12),
                           chain=chain)


def test_gpu_tiers_under_the_v5e_chain_give_the_tpu_rows():
    ref_rows, ref_derived = _rows(jtiers)
    rows, derived = _rows(beyond_gpu_tiers, hier=_v5e_serving_chain())
    assert [d for _, d in rows] == [d for _, d in ref_rows]
    assert derived == ref_derived


def test_gpu_tiers_on_the_h100():
    """At 80 GB llava15-13b's weights and 33,000 positions of KV fit HBM;
    deepseek-v2-236b's weights do not; host-offloaded KV is PCIe-bound."""
    rows = dict(_rows(beyond_gpu_tiers)[0])
    llava = rows["beyond.gpu_tiers.llava15-13b"]
    assert "DOES-NOT-FIT" not in llava
    assert "kv-host-offload:" in llava and llava.split()[1].endswith("/hbs")
    assert rows["beyond.gpu_tiers.deepseek-v2-236b"].startswith(
        "all-hbm:DOES-NOT-FIT kv-host-offload:DOES-NOT-FIT")
    assert len(rows) == 12


def test_gpu_tiers_fit_test_follows_the_hierarchys_hbm():
    """The fit test reads the hierarchy's own HBM capacity: at 16 GB
    llava15-13b's all-HBM placement no longer fits, at 80 GB it does."""
    small = dict(_rows(beyond_gpu_tiers, hier=h100_hierarchy(hbm_gb=16.0))[0])
    full = dict(_rows(beyond_gpu_tiers, hier=h100_hierarchy())[0])
    key = "beyond.gpu_tiers.llava15-13b"
    assert small[key].startswith("all-hbm:DOES-NOT-FIT")
    assert not full[key].startswith("all-hbm:DOES-NOT-FIT")
    assert small != full


def test_stco_sweep_prints_the_reference():
    ref, port = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(ref):
        runpy.run_path(str(ROOT / "examples" / "stco_sweep.py"))
    with contextlib.redirect_stdout(port):
        stco_sweep.main()
    assert port.getvalue() == ref.getvalue()
    assert len(port.getvalue().splitlines()) == 13


def test_concurrency_analytical_halves_print_the_reference(capsys):
    jcs.analytical()
    jcs.shared_prefix_analytical()
    ref = capsys.readouterr().out
    tcs.analytical()
    tcs.shared_prefix_analytical()
    assert capsys.readouterr().out == ref


# ------------------ concurrency_sweep's runtime halves ------------------ #

@pytest.fixture(scope="module")
def twin():
    """The reference's reduced twin and its weights (PRNGKey 0, f32), and
    the port's runtime halves served on the CPU with those weights."""
    cfg = reduced(get_config(tcs.ARCH), d_model=128, n_layers=4, vocab=512)
    opts = RuntimeOptions(dtype="float32")
    jp = init_params(cfg, jax.random.PRNGKey(0), opts)
    tp = tm.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        runtime = tcs.runtime("cpu", params=tp)
        shared = tcs.shared_prefix_runtime("cpu", params=tp)
    return cfg, opts, jp, runtime, shared


def _jax_serve(cfg, opts, jp, reqs, sched, **kw):
    eng = JaxEngine(cfg, jp, opts, max_len=96, scheduler=sched, page_size=16,
                    max_batch=8, **kw)
    eng.serve([r[:] for r in reqs], 16)
    eng.stats.__init__()
    return eng.serve([r[:] for r in reqs], 16), eng.stats


def test_runtime_model_on_each_device():
    cfg, opts, _ = tcs.runtime_model("cpu")
    assert (cfg.d_model, cfg.n_layers, cfg.vocab, opts.dtype) == (
        128, 4, 512, "float32")
    cfg, opts, _ = tcs.runtime_model("cuda")
    assert (cfg.d_model, cfg.n_layers, opts.dtype) == (2048, 16, "bfloat16")


@pytest.mark.parametrize("sched", ["static", "continuous"])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_runtime_equals_the_jax_engines(twin, n, sched):
    cfg, opts, jp, runtime, _ = twin
    res = runtime[n]
    assert len(res["requests"]) == n
    want, st = _jax_serve(cfg, opts, jp, res["requests"], sched)
    assert res[sched]["tokens"] == want
    assert ({k: res[sched]["stats"][k] for k in COUNTERS}
            == {k: getattr(st, k) for k in COUNTERS})


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_shared_prefix_runtime_equals_the_jax_engine(twin, prefix_cache):
    cfg, opts, jp, _, shared = twin
    want, st = _jax_serve(cfg, opts, jp, shared["requests"], "continuous",
                          prefix_cache=prefix_cache)
    got = shared[prefix_cache]
    assert got["tokens"] == want
    assert ({k: got["stats"][k] for k in COUNTERS}
            == {k: getattr(st, k) for k in COUNTERS})
    if prefix_cache:
        assert got["stats"]["pages_deduped"] > 0
        assert shared["measured"] == pytest.approx(0.4)
        assert shared["predicted"] == pytest.approx(4 / 9)


def test_concurrency_cli_defaults_to_cuda(monkeypatch):
    seen = []
    monkeypatch.setattr(tcs, "runtime", lambda d: seen.append(d))
    monkeypatch.setattr(tcs, "shared_prefix_runtime",
                        lambda d: seen.append(d))
    with contextlib.redirect_stdout(io.StringIO()):
        tcs.main([])
        tcs.main(["--device", "cpu"])
        tcs.main(["--skip-runtime"])
    assert seen == ["cuda", "cuda", "cpu", "cpu"]
