"""The port's ``paper.hbs_sweep`` and ``paper.chiplet_sweep`` against the
reference's ``benchmarks/hbs_sweep.py`` and ``benchmarks/chiplet_sweep.py``:
the analytic halves at the reference's defaults dict for dict; the
measured halves on the reduced twin at a cut grid (one stingy bandwidth,
one latency and the generous point; chiplet pages 0 and 2) with the
reference's weights, every field a cell's schedule fixes equal and every
cell token-identical to its no-offload baseline. Both packages' engines
run prefill and decode on one stream (``overlap=False``) there, so the
schedule follows the requests and not the measured step times (see
``repro_torch.paper.common.SCHEDULE_COUNTERS``). Also ``goodput_summary``,
the CLIs' ``--out`` and default device, and ``launch.mesh.make_host_mesh``
(no CPU fallback)."""
import contextlib
import dataclasses
import functools
import importlib
import io
import json
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

import repro.serving
from repro.configs import get_config
from repro.configs.reduce import reduced
from repro.models import RuntimeOptions, init_params
from repro.serving import ServeEngine as JaxEngine
import repro_torch.models as tm
from repro_torch.launch import mesh as tmesh
from repro_torch.paper import chiplet_sweep as tchip
from repro_torch.paper import common as tcommon
from repro_torch.paper import hbs_sweep as thbs

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import benchmarks.common as jcommon  # noqa: E402

torch.set_num_threads(2)

SWEEPS = {"hbs_sweep": (thbs, "analytic_13b"),
          "chiplet_sweep": (tchip, "analytic_1b")}
# the cut grids, as each module's flags
CUT = {"hbs_sweep": ["--measured-bw-gbps", "0.002",
                     "--measured-latency-us", "20"],
       "chiplet_sweep": ["--chiplet-pages", "0,2"]}
# the fields a cell's schedule fixes (the rest are step times or follow
# them: stall, TPS, ITL, goodput, prefetch and chiplet hit rates)
HBS_CELL = ("bw_gbps", "latency_us", "spill_mb", "fetch_mb",
            "peak_fast_pages", "preemptions", "token_identical",
            "kv_split_at_peak")
CHIPLET_CELL = ("chiplet_pages", "policy", "writeback_link", "bw_gbps",
                "chiplet_promotions", "chiplet_demotions", "clean_demotions",
                "spill_mb", "fetch_mb", "channel_mb", "token_identical",
                "trace_reconciled")
TOP = ("arch", "n_requests", "prompt_len", "new_tokens", "fast_pages",
       "page_kb")
HBS_DERIVED = ("generous_token_identical", "generous_stall_ms",
               "all_token_identical", "stall_grows_as_bw_shrinks",
               "predicted_from_runtime_split")
CHIPLET_DERIVED = ("all_token_identical", "all_traces_reconciled",
                   "hit_rate_grows_with_chiplet", "generous_stall_ms")


def _reference_main(name, argv, monkeypatch, measured=None):
    """The reference module's ``main`` on ``argv`` (its own parser and
    defaults), its measured half replaced by ``measured``; returns the
    printed JSON."""
    ref = importlib.import_module(f"benchmarks.{name}")
    monkeypatch.setattr(ref, "measured_section",
                        measured or (lambda args: {}))
    monkeypatch.setattr(sys, "argv", [name, *argv])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ref.main()
    return json.loads(out.getvalue())


@pytest.mark.parametrize("name", list(SWEEPS))
def test_analytic_half_equals_the_reference(name, monkeypatch):
    port, key = SWEEPS[name]
    want = _reference_main(name, [], monkeypatch)[key]
    assert port.analytic_section(port.parser().parse_args([])) == want


@pytest.fixture(scope="module")
def measured():
    """Each measured half at the cut grid: the reference's (its own
    weights, PRNGKey 0) and the port's on the same weights, both with
    serialized streams."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(repro.serving, "ServeEngine",
                   functools.partial(JaxEngine, overlap=False))
        for name, (port, _) in SWEEPS.items():
            args = port.parser().parse_args(["--device", "cpu", *CUT[name]])
            cfg = port.twin_config()
            jcfg = dataclasses.replace(
                reduced(get_config(cfg.name.split("-reduced")[0]),
                        d_model=128, n_layers=4, vocab=512),
                family="dense", prefix_len=0, source_len=0, name=cfg.name)
            jp = init_params(jcfg, jax.random.PRNGKey(0),
                             RuntimeOptions(dtype="float32"))
            tp = tm.params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                             jp),
                                      device="cpu")
            ref = importlib.import_module(f"benchmarks.{name}")
            with contextlib.redirect_stdout(io.StringIO()):
                want = ref.measured_section(args)
                got = port.measured_section(args, params=tp, overlap=False)
            out[name] = (jcfg, cfg, want, got)
    return out


def test_twins_are_the_references(measured):
    for jcfg, cfg, _, _ in measured.values():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)


@pytest.mark.parametrize("name,cell_keys,derived", [
    ("hbs_sweep", HBS_CELL, HBS_DERIVED),
    ("chiplet_sweep", CHIPLET_CELL, CHIPLET_DERIVED)])
def test_measured_half_equals_the_reference(measured, name, cell_keys,
                                            derived):
    _, _, want, got = measured[name]
    assert {k: got[k] for k in TOP} == {k: want[k] for k in TOP}
    assert got["bw_scale"] == 1.0 and got["overlap"] is False
    assert len(got["grid"]) == len(want["grid"])
    for g, w in zip(got["grid"], want["grid"]):
        assert {k: g[k] for k in cell_keys} == {k: w[k] for k in cell_keys}
        assert g["token_identical"] and g["trace_reconciled"]
        c = g["counters"]
        assert c["pages_spilled"] > 0 and c["pages_fetched"] > 0
        assert c["channel_pages"].get("ddr->chiplet", 0) == (
            c["chiplet_promotions"])
    assert ({k: got["derived"][k] for k in derived}
            == {k: want["derived"][k] for k in derived})
    assert got["derived"]["generous_stall_ms"] == 0.0


def test_chiplet_cells_hold_the_gates(measured):
    """The overlap cells save no less than 0 against their barrier
    counterfactual, and on the dedicated link stall at most the barrier
    run of their chiplet size; the barrier cells save nothing; every
    chiplet cell promotes, and its hit rate is above 0."""
    _, _, _, got = measured["chiplet_sweep"]
    assert got["n_layer_slices"] == 4
    for c in got["grid"]:
        if c["policy"] == "overlap":
            assert c["n_layer_slices"] == 4
            assert c["stall_saved_s"] >= 0.0
        else:
            assert c["n_layer_slices"] == 1 and c["stall_saved_s"] == 0.0
        if c["chiplet_pages"]:
            assert c["chiplet_promotions"] > 0
    assert got["overlap_vs_barrier"]
    for p in got["overlap_vs_barrier"]:
        assert p["overlap_stall_ms"] <= p["barrier_run_stall_ms"]
    assert got["derived"]["hit_rate_by_chiplet_pages"][2] > 0.0


def test_goodput_summary_equals_the_reference():
    report = {"goodput_frac": 0.5, "n_met_slo": 2, "n_requests": 4,
              "violators": [{"rid": 1, "blame": "stall"},
                            {"rid": 3, "blame": "decode"},
                            {"rid": 2, "blame": "stall"}]}
    assert tcommon.goodput_summary(report) == jcommon.goodput_summary(report)


@pytest.mark.parametrize("name", list(SWEEPS))
def test_cli_out_writes_the_printed_json(name, tmp_path, capsys):
    port, key = SWEEPS[name]
    small = ["--prompt-len", "32", "--new-tokens", "8"] + (
        ["--measured-bw-gbps", "0.2", "--measured-latency-us", "20"]
        if name == "hbs_sweep" else ["--chiplet-pages", "2"])
    path = tmp_path / "out" / f"{name}.json"
    res = port.main(["--device", "cpu", "--out", str(path), *small])
    printed = capsys.readouterr().out
    assert path.read_text() == printed
    assert json.loads(printed) == json.loads(json.dumps(res))
    assert set(res) == {key, "measured_reduced"}
    assert res["measured_reduced"]["derived"]["all_token_identical"]


@pytest.mark.parametrize("name", list(SWEEPS))
def test_cli_defaults_to_cuda(name):
    port, _ = SWEEPS[name]
    assert port.parser().parse_args([]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with contextlib.redirect_stdout(io.StringIO()), \
            pytest.raises(RuntimeError, match="CUDA"):
        port.measured_section(port.parser().parse_args([]))


@pytest.mark.parametrize("name", list(SWEEPS))
def test_sweep_imports_only_the_port(name):
    text = (ROOT / "src" / "repro_torch" / "paper" / f"{name}.py").read_text()
    lines = [ln.strip() for ln in text.splitlines()]
    assert not [ln for ln in lines
                if ln.startswith(("import jax", "from jax", "import repro.",
                                  "from repro.", "from repro import",
                                  "from benchmarks", "import benchmarks"))]
    assert "BENCH_" not in text and "merge_bench_json" not in text


def test_card_models_at_full_width():
    """On the card: llava15-13b's decoder at full width, 5 layers, bf16
    (pages 50 times the twin's); llama3.2-1b at full width and depth (64
    times)."""
    from repro_torch.models import kernel_width_reason
    from repro_torch.serving.kv_manager import page_bytes
    cfg, opts = thbs.measured_model("cuda")
    assert (cfg.family, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab, cfg.n_layers, opts.dtype) == (
        "dense", 5120, 40, 40, 128, 20480, 32000, 5, "bfloat16")
    assert page_bytes(cfg, 16, 2) == 1_638_400 == 50 * page_bytes(
        thbs.twin_config(), 16, 4)
    cfg1, opts1 = tchip.measured_model("cuda")
    assert (cfg1.d_model, cfg1.n_layers, opts1.dtype) == (2048, 16,
                                                          "bfloat16")
    assert page_bytes(cfg1, 16, 2) == 2_097_152 == 64 * page_bytes(
        tchip.twin_config(), 16, 4)
    for c in (cfg, cfg1):
        assert kernel_width_reason(c, "paged") is None
    assert kernel_width_reason(thbs.twin_config(), "paged")


def test_make_host_mesh_on_the_cpu():
    import torch.distributed as dist
    if dist.is_initialized():
        pytest.skip("a process group exists in this process")
    try:
        mesh = tmesh.make_host_mesh(device="cpu")
        assert mesh.device_type == "cpu"
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.shape) == (1, 1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_make_host_mesh_has_no_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    import torch.distributed as dist
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.make_host_mesh()
    assert not dist.is_initialized()
