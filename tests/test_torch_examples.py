"""The port's trace check and examples (``repro_torch.serving.check_trace``,
``repro_torch.examples.{quickstart,serve_batched,train_100m}``) against
the reference's ``scripts/check_trace.py`` and ``examples/``, on the CPU.

* check_trace: on a trace the port's serve CLI writes (``--device cpu
  --reduced ... --trace-out``) both give the same verdict, line and exit
  code, with and without ``--strict-vocab``; on a copy carrying a channel
  label outside ``CHANNEL_LABELS`` (under ``--strict-vocab``) and on one
  whose breakdown's phases do not sum to its latency, both exit with 1.
* quickstart: the port prints the reference's lines, number for number.
* serve_batched: on the reference's weights (``params_from_numpy``) and
  the same prompts, the port's serves give the JAX engine's tokens (the
  example's config at head width 64, a smaller wave than its default).
* train_100m: ``--tiny --steps 4`` (a checkpoint every 2 steps); a run
  restarted from step 2 (the step-4 checkpoint removed, the same command
  again) repeats the straight run's losses and its step-4 checkpoint
  bitwise.
"""
import contextlib
import importlib.util
import io
import json
import runpy
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.launch.serve as tserve
import repro_torch.models as tm
from repro.configs import get_config
from repro.configs.reduce import reduced
from repro.models import RuntimeOptions, init_params
from repro.serving import ServeEngine as JaxEngine
from repro_torch.examples import quickstart, serve_batched, train_100m
from repro_torch.serving import check_trace
from repro_torch.serving.channels import CHANNEL_LABELS

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]


def _reference(rel: str):
    spec = importlib.util.spec_from_file_location(
        rel.replace("/", "_")[:-3], ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ref_check(argv):
    """The reference script's exit code and printed line."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = _reference("scripts/check_trace.py").main(argv)
    return rc, buf.getvalue().strip()


def _port_check(argv):
    with contextlib.redirect_stdout(io.StringIO()):
        rc, line = check_trace.main(argv)
    return rc, line


# ------------------------------ check_trace ----------------------------- #

@pytest.fixture(scope="module")
def trace(tmp_path_factory):
    """A continuous serve's trace from the port's CLI on the CPU."""
    path = tmp_path_factory.mktemp("trace") / "serve.json"
    with contextlib.redirect_stdout(io.StringIO()):
        tserve.main(["--arch", "llama3.2-1b", "--reduced", "--device", "cpu",
                     "--scheduler", "continuous", "--concurrency", "5",
                     "--prompt-len", "24", "--new-tokens", "8",
                     "--trace-out", str(path)])
    return path


@pytest.mark.parametrize("strict", [False, True])
def test_check_trace_agrees_on_a_port_trace(trace, strict):
    argv = (["--strict-vocab"] if strict else []) + [str(trace)]
    rc, line = _port_check(argv)
    assert (rc, line) == _ref_check(argv)
    assert rc == 0 and line.startswith("[check_trace] OK")
    doc = json.loads(trace.read_text())
    assert f"{len(doc['metadata']['breakdowns'])} request breakdowns" in line
    assert "5 request breakdowns" in line


def _corrupt(trace, tmp_path, kind):
    doc = json.loads(trace.read_text())
    if kind == "label":
        doc["traceEvents"].append(dict(ph="X", name="fetch", pid=2, tid=1,
                                       ts=0, dur=1,
                                       args=dict(link="ddr->nowhere")))
    else:
        rid = sorted(doc["metadata"]["breakdowns"])[0]
        doc["metadata"]["breakdowns"][rid]["decode_s"] += 1e-3
    path = tmp_path / f"{kind}.json"
    path.write_text(json.dumps(doc))
    return path


@pytest.mark.parametrize("kind", ["label", "sum"])
def test_check_trace_fails_where_the_reference_fails(trace, tmp_path, kind):
    """A label outside the vocabulary fails only under --strict-vocab; a
    breakdown off its latency by 1 ms fails either way; both exit 1."""
    path = _corrupt(trace, tmp_path, kind)
    assert "ddr->nowhere" not in CHANNEL_LABELS
    argv = ["--strict-vocab", str(path)]
    rc, line = _port_check(argv)
    ref_rc, ref_line = _ref_check(argv)
    assert rc == ref_rc == 1
    assert line.startswith("[check_trace] FAIL")
    # the messages name the same request or label (the module paths differ)
    assert line.split(" not in ")[0] == ref_line.split(" not in ")[0]
    lax = _port_check([str(path)])[0], _ref_check([str(path)])[0]
    assert lax == ((0, 0) if kind == "label" else (1, 1))


def test_check_trace_raises_on_a_malformed_trace(tmp_path):
    path = tmp_path / "bad.json"
    path.write_text(json.dumps({"traceEvents": []}))
    for fn in (_port_check, _ref_check):
        with pytest.raises(ValueError, match="non-empty"):
            fn([str(path)])


# ------------------------------- quickstart ----------------------------- #

def test_quickstart_prints_the_reference_numbers():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        runpy.run_path(str(ROOT / "examples" / "quickstart.py"))
    with contextlib.redirect_stdout(io.StringIO()) as port_out:
        text = quickstart.main([])
    assert text == buf.getvalue() == port_out.getvalue()
    assert "TPS=" in text and "bottleneck=" in text


# ------------------------------ serve_batched --------------------------- #

def test_serve_batched_matches_the_jax_engine():
    """The example's three serves on the reference's f32 weights: native
    and int8 ``generate``, ``serve_bucketed`` and the continuous engine
    give the JAX engine's tokens (2 prompts of 16 tokens, 8 new)."""
    tcfg = serve_batched.example_config()
    cfg = reduced(get_config("llama3.2-1b"), d_model=256, n_layers=6,
                  vocab=4096).replace(head_dim=64)
    assert (tcfg.d_model, tcfg.n_layers, tcfg.vocab, tcfg.head_dim) == (
        cfg.d_model, cfg.n_layers, cfg.vocab, cfg.head_dim) == (
        256, 6, 4096, 64)
    opts = RuntimeOptions(dtype="float32")
    jp = init_params(cfg, jax.random.PRNGKey(0), opts)
    tp = tm.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    prompts = serve_batched.prompts_for(tcfg, 2, 16)
    lines = []
    got = serve_batched.run(tcfg, tp, prompts, 8, "cpu", lines.append)
    assert len(lines) == 6 and lines[0].startswith("kv=native")
    kw = dict(max_len=serve_batched.MAX_LEN)
    for policy in ("native", "int8"):
        eng = JaxEngine(cfg, jp, opts, kv_policy=policy, **kw)
        assert got[policy] == eng.generate(jnp.asarray(prompts), 8), policy
    reqs = serve_batched.RAGGED
    eng = JaxEngine(cfg, jp, opts, **kw)
    assert got["bucketed"] == eng.serve_bucketed([r[:] for r in reqs], 8)
    ceng = JaxEngine(cfg, jp, opts, scheduler="continuous", page_size=16,
                     max_batch=8, **kw)
    assert got["continuous"] == ceng.serve([r[:] for r in reqs], 8)


def test_serve_batched_cli_on_the_cpu():
    with contextlib.redirect_stdout(io.StringIO()):
        text = serve_batched.main(["--device", "cpu"])
    assert text.count("kv=") == 2 and "5 responses" in text
    assert "continuous batching" in text


# ------------------------------- train_100m ----------------------------- #

def _train(ckpt, *extra):
    with contextlib.redirect_stdout(io.StringIO()):
        return train_100m.main(["--tiny", "--steps", "4", "--device", "cpu",
                                "--ckpt-dir", str(ckpt), *extra])


def _losses(ckpt):
    return [json.loads(line)["loss"]
            for line in (ckpt / "metrics.jsonl").read_text().splitlines()]


def _leaves(ckpt, step):
    with np.load(ckpt / f"step_{step}" / "leaves.npz") as z:
        return {k: z[k] for k in z.files}


@pytest.fixture
def one_thread():
    """PyTorch's CPU backward sums in an order that follows its threads: two
    straight runs on 2 threads differ in the last bits of their step-2
    weights. On one thread a run repeats itself bitwise, so a restart can
    be held to it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_train_100m_resumes_bitwise(tmp_path, one_thread):
    straight, restarted = tmp_path / "straight", tmp_path / "restarted"
    text = _train(straight, "--fresh")
    assert "arch=qwen2.5-3b" in text and "over 4 steps" in text
    first = _losses(straight)
    assert len(first) == 4 and first[-1] < first[0]
    _train(restarted, "--fresh")
    shutil.rmtree(restarted / "step_4")        # lost after step 2's save
    text = _train(restarted)
    assert "resumed from step 2" in text and "over 4 steps" in text
    again = _losses(restarted)
    assert again[:4] == first and again[4:] == first[2:]   # bitwise floats
    a, b = _leaves(straight, 4), _leaves(restarted, 4)
    assert a.keys() == b.keys()
    assert all(np.array_equal(a[k], b[k]) for k in a)
    text = _train(restarted)
    assert "nothing to run" in text
