"""The port's ``paper.spec_sweep`` against the reference's
``benchmarks/spec_sweep.py`` on its reduced twin (f32, d_model 256, 4
layers, vocab 512; 4 requests of a shared 96-token document plus 8
tokens, 64 new) at a cut grid: k of 4 and 8, one stingy HBS bandwidth and
the generous point. Both packages' sections run on the reference's
weights with prefill and decode on one stream (``overlap=False``), so
their schedules follow the requests and not the measured step times: the
tokens and every counter the schedule fixes must be equal, and the model
draft, handed the reference engine's draft weights, must accept what the
reference's accepts. Also the CLI's ``--out`` and default device, the
module's imports, and the card's full-width target and draft."""
import argparse
import contextlib
import dataclasses
import importlib
import io
import json
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.configs.reduce import reduced
from repro.models import RuntimeOptions, init_params
import repro_torch.models as tm
from repro_torch.paper import common as tcommon
from repro_torch.paper import spec_sweep as tspec

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

torch.set_num_threads(2)

# the cut grid, as the module's flags
CUT = ["--device", "cpu", "--k-sweep", "4,8", "--hbs-bw-gbps", "0.002"]
NGRAM_ROW = ("k", "acceptance_rate", "draft_proposed", "draft_accepted",
             "spec_blocks", "decode_steps", "host_syncs", "token_identical")
DRAFT = ("acceptance_rate", "draft_proposed", "draft_accepted",
         "token_identical")
HBS_MODE = ("fetch_mb", "acceptance_rate")
COUNTERS = tspec.SPEC_COUNTERS + tcommon.SCHEDULE_COUNTERS


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def sweeps():
    """Each section of both packages on the twin: the reference's (its own
    weights, PRNGKey 0, and the engines it made), and the port's on the
    same weights (the model draft's too), both with serialized streams."""
    ref = importlib.import_module("benchmarks.spec_sweep")
    args = tspec.parser().parse_args(CUT)
    cfg = reduced(get_config(args.arch), d_model=args.d_model,
                  n_layers=args.n_layers, vocab=args.vocab)
    opts = RuntimeOptions(dtype="float32")
    jp = init_params(cfg, jax.random.PRNGKey(0), opts)
    reqs = ref._workload(cfg, args)
    common = dict(max_len=args.doc_len + args.tail_len + args.new_tokens,
                  scheduler="continuous", page_size=16, max_batch=4,
                  prefix_cache=True, overlap=False)
    engines = []
    mk = ref._mk

    def recorded(*a, **kw):
        engines.append(mk(*a, **kw))
        return engines[-1]

    tp = tm.params_from_numpy(_np_tree(jp), device="cpu")
    want, got = {}, {}
    with pytest.MonkeyPatch.context() as mp, \
            contextlib.redirect_stdout(io.StringIO()):
        mp.setattr(ref, "_mk", recorded)
        for name in ("ngram", "model_draft", "spec_x_hbs"):
            del engines[:]
            want[name] = (getattr(ref, f"{name}_section")(
                cfg, jp, opts, common, reqs, args), list(engines))
        draft = [e for e in want["model_draft"][1]
                 if e.spec_mode == "model"][0]
        tdp = tm.params_from_numpy(_np_tree(draft.draft_params),
                                   device="cpu")
        got["ngram"] = tspec.ngram_section(args, tp, overlap=False)
        got["model_draft"] = tspec.model_draft_section(
            args, tp, overlap=False, draft_params=tdp)
        got["spec_x_hbs"] = tspec.spec_x_hbs_section(
            args, tp, overlap=False,
            want=got["ngram"]["baseline_outputs"])
    return cfg, args, want, got


def test_twins_are_the_references(sweeps):
    cfg, args, _, _ = sweeps
    assert dataclasses.asdict(tspec.twin_config(args)) == \
        dataclasses.asdict(cfg)
    tcfg, opts = tspec.measured_model(args)
    assert tcfg.name == cfg.name and opts.dtype == "float32"
    dcfg = tspec.draft_config(tcfg, args)
    want = dataclasses.replace(
        reduced(get_config(args.arch), d_model=args.d_model // 2,
                n_layers=1, vocab=cfg.vocab), name=cfg.name + "-draft")
    assert dataclasses.asdict(dcfg) == dataclasses.asdict(want)


def test_ngram_section_equals_the_reference(sweeps):
    _, _, want, got = sweeps
    w, g = want["ngram"][0], got["ngram"]
    assert g["baseline_decode_steps"] == w["baseline_decode_steps"]
    assert len(g["sweep"]) == len(w["sweep"]) == 2
    for gr, wr in zip(g["sweep"], w["sweep"]):
        assert {k: gr[k] for k in NGRAM_ROW} == {k: wr[k] for k in NGRAM_ROW}
        assert gr["token_identical"] and gr["trace_reconciled"]
        assert gr["pages_left"] == 0 and gr["draft_accepted"] > 0
        assert gr["weights"] == tspec.WEIGHTS
    assert g["derived"]["all_token_identical"] == \
        w["derived"]["all_token_identical"] is True
    # the baseline engine's counters are the reference baseline's
    base = want["ngram"][1][0]
    assert g["baseline"]["counters"] == {
        k: getattr(base.stats, k) for k in tspec.SPEC_COUNTERS}
    assert g["overlap"] is False and g["dtype"] == "float32"


def test_model_draft_equals_the_reference(sweeps):
    """The half-width, 1-layer draft on the reference engine's draft
    weights: the sync / catch-up / rollback protocol accepts the same
    tokens, and the target's output is spec-off's."""
    _, _, want, got = sweeps
    w, g = want["model_draft"][0], got["model_draft"]
    assert {k: g[k] for k in DRAFT} == {k: w[k] for k in DRAFT}
    assert g["token_identical"] and g["draft_proposed"] > 0
    assert g["trace_reconciled"] and g["pages_left"] == 0
    eng = [e for e in want["model_draft"][1] if e.spec_mode == "model"][0]
    assert g["counters"] == {k: getattr(eng.stats, k)
                             for k in tspec.SPEC_COUNTERS}
    assert g["draft_arch"] == w["draft_arch"] and g["k"] == w["k"] == 8


def test_spec_x_hbs_equals_the_reference(sweeps):
    """Spec off and n-gram over the capped fast tier: every counter the
    schedule fixes equals the reference engine's, every cell's tokens
    are spec-off's without tiers, the generous point stalls 0 and the
    stingy one more."""
    _, _, want, got = sweeps
    (w, engines), g = want["spec_x_hbs"], got["spec_x_hbs"]
    assert g["fast_pages"] == w["fast_pages"]
    assert g["bw_scale"] == 1.0 and g["twin_bw_gbps"] == [0.002]
    assert len(g["grid"]) == len(w["grid"]) == 2
    cells = [(gc[m], wc[m]) for gc, wc in zip(g["grid"], w["grid"])
             for m in ("off", "ngram")]
    assert len(engines) == len(cells)
    for (gm, wm), eng in zip(cells, engines):
        assert {k: gm[k] for k in HBS_MODE} == {k: wm[k] for k in HBS_MODE}
        s = eng.stats
        assert {k: gm["counters"][k] for k in COUNTERS} == {
            k: getattr(s, k) for k in COUNTERS}
        assert gm["token_identical"] and gm["trace_reconciled"]
        assert gm["pages_left"] == 0
        assert gm["counters"]["pages_fetched"] > 0
    assert [c["bw_gbps"] for c in g["grid"]] == [
        c["bw_gbps"] for c in w["grid"]]
    stingy, generous = g["grid"]
    for m in ("off", "ngram"):
        assert generous[m]["stall_ms"] == 0.0 < stingy[m]["stall_ms"]
    assert generous["ngram"]["counters"]["spec_blocks"] > 0


def test_cli_out_writes_the_printed_json(tmp_path, capsys):
    path = tmp_path / "out" / "spec_sweep.json"
    res = tspec.main(["--device", "cpu", "--out", str(path), "--k-sweep",
                      "4", "--hbs-bw-gbps", "0.02", "--new-tokens", "16",
                      "--skip-model-draft"])
    printed = capsys.readouterr().out
    assert path.read_text() == printed
    assert json.loads(printed) == json.loads(json.dumps(res))
    assert set(res) == {"workload", "ngram", "spec_x_hbs"}
    assert res["workload"]["weights"] == tspec.WEIGHTS
    assert res["ngram"]["derived"]["all_token_identical"]
    assert all(c[m]["token_identical"] for c in res["spec_x_hbs"]["grid"]
               for m in ("off", "ngram"))


def test_cli_defaults_to_cuda():
    assert tspec.parser().parse_args([]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with contextlib.redirect_stdout(io.StringIO()), \
            pytest.raises(RuntimeError, match="CUDA"):
        tspec.main([])
    with pytest.raises(RuntimeError, match="CUDA"):
        tspec.ngram_section(tspec.parser().parse_args([]))


def test_sweep_imports_only_the_port():
    text = (ROOT / "src" / "repro_torch" / "paper"
            / "spec_sweep.py").read_text()
    lines = [ln.strip() for ln in text.splitlines()]
    assert not [ln for ln in lines
                if ln.startswith(("import jax", "from jax", "import repro.",
                                  "from repro.", "from repro import",
                                  "from benchmarks", "import benchmarks"))]
    assert "BENCH_" not in text and "merge_bench_json" not in text


def test_card_models_at_full_width():
    """On the card: llama3.2-1b at full width in bf16, 4 of its 16
    layers, a draft of half its width at heads of 64 (16 over 16 KV
    heads, d_ff 4,096, 1 layer, its vocab, a head of its own where the
    target ties its head to the embedding), both taken by the kernels;
    pages 16 times the twin's, so the HBS grid is 0.032 and 0.32 GB/s; 11
    pages a sequence, a fast tier of 14 of the 44."""
    from repro_torch.models import kernel_width_reason
    from repro_torch.serving.kv_manager import page_bytes
    args = tspec.parser().parse_args([])
    cfg, opts = tspec.measured_model(args)
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.n_layers, cfg.vocab, opts.dtype) == (
        2048, 32, 32, 64, tspec.CARD_LAYERS, 128256, "bfloat16")
    assert tspec.CARD_LAYERS == 4
    dcfg = tspec.draft_config(cfg, args)
    assert (dcfg.d_model, dcfg.n_heads, dcfg.n_kv_heads, dcfg.head_dim,
            dcfg.d_ff, dcfg.n_layers, dcfg.vocab) == (
        1024, 16, 16, 64, 4096, 1, 128256)
    assert cfg.tie_embeddings and not dcfg.tie_embeddings
    for c in (cfg, dcfg):
        assert kernel_width_reason(c, "paged") is None
    assert kernel_width_reason(tspec.draft_config(
        tspec.twin_config(args), argparse.Namespace(
            **dict(vars(args), device="cpu"))), "paged")
    pb = page_bytes(cfg, 16, 2)
    assert pb == 524_288 == 16 * page_bytes(tspec.twin_config(args), 16, 4)
    assert [round(b * 16, 12) for b in (0.002, 0.02)] == [0.032, 0.32]
    _, _, common, reqs = tspec._setup(args, False)
    assert common["max_len"] == 168
    pages = [-(-(len(r) + args.new_tokens) // 16) for r in reqs]
    assert pages == [11] * 4 and max(sum(pages) // 3, 2) == 14


def test_untied_draft_head_has_proposals_rejected():
    """Why the card's draft unties its head: a random target with a tied
    head repeats its prompt's last token, so a tied random draft repeats
    it too and has every proposal accepted, while an untied one has them
    rejected (the reject, rollback and catch-up path), with the tokens
    unchanged. At a width where the repeat shows (d_model 512), on the
    CPU."""
    from repro_torch.configs import get_config as tget_config
    from repro_torch.configs.reduce import reduced as treduced
    from repro_torch.serving import ServeEngine as TServeEngine
    cfg = dataclasses.replace(
        treduced(tget_config("llama3.2-1b"), d_model=512, n_layers=2,
                 vocab=8192), n_heads=8, n_kv_heads=8)
    assert cfg.tie_embeddings
    rng = np.random.default_rng(0)
    doc = rng.integers(1, cfg.vocab, size=96).tolist()
    reqs = [doc + rng.integers(1, cfg.vocab, size=8).tolist()
            for _ in range(4)]
    common = dict(max_batch=4, max_len=168, page_size=16,
                  scheduler="continuous", device="cpu")
    opts = tm.RuntimeOptions(dtype="float32")
    base = TServeEngine(cfg, None, opts, **common)
    want = base.serve(reqs, 16)
    assert want == [[r[-1]] * 16 for r in reqs]
    counts = {}
    for tied in (True, False):
        dcfg = dataclasses.replace(cfg, d_model=256, n_heads=4, n_kv_heads=4,
                                   d_ff=cfg.d_ff // 2, n_layers=1,
                                   tie_embeddings=tied)
        eng = TServeEngine(cfg, base.params, opts, spec_mode="model",
                           spec_k=4, draft_cfg=dcfg, **common)
        assert eng.serve(reqs, 16) == want
        counts[tied] = (eng.stats.draft_proposed, eng.stats.draft_accepted,
                        eng.drafter.passes["catchups"])
    assert counts[True][0] == counts[True][1] > 0
    assert counts[False][1] < counts[False][0]
    assert counts[False][2] > counts[True][2]
