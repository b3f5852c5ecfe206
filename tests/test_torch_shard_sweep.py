"""The port's ``paper.shard_sweep`` on its reduced twin (f32, d_model 64,
2 layers, vocab 128, 4 KV heads; 8 requests of 24 and 8 tokens, 16 new,
pages of 8, 3 slots) against the reference's ``benchmarks/shard_sweep.py``
at one shard, where the reference's JAX engine runs in any pytest worker
(its meshes need 4 host devices, which a worker's JAX may not have): the
overlap section's tokens and serialized counters, and the capacity
section's single-device cells. The mesh cells at 2 and 4 shards run on
gloo ranks of the CPU (one rank group each, as ``run_groups`` spawns
them) and must give the one-shard tokens; the analytic bridge equals the
reference's arithmetic. Streams are serialized (``overlap=False``)
wherever counters are compared. Also the CLI's ``--out`` and default
device, and the module's imports."""
import contextlib
import dataclasses
import importlib
import io
import json
import os
import pathlib
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
import repro_torch.models as tm
from repro_torch.paper import shard_sweep as tshard

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

torch.set_num_threads(2)

COUNTERS = ("decode_steps", "host_syncs", "preemptions", "peak_fast_pages",
            "peak_pages_used")


def _reference_module():
    """``benchmarks.shard_sweep``, imported without leaving its host
    device count in this worker's XLA_FLAGS (its import prepends it for
    the JAX it would initialize; this worker's JAX is already up)."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("benchmarks.shard_sweep")
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved


def _reference_capacity(cfg, args):
    """The reference's capacity requests and concurrent-mix tiers
    (``capacity_section``), in the reference's own types."""
    from repro.core import hbs, lpddr6, npu_hierarchy
    from repro.serving.kv_manager import page_bytes
    ps = args.page_size
    pb = page_bytes(cfg, ps, 4)
    rng = np.random.default_rng(7)
    long_req = rng.integers(1, cfg.vocab, size=3 * ps).tolist()
    conc = [rng.integers(1, cfg.vocab, size=2 * ps).tolist()
            for _ in range(4)]
    need = sum(-(-(len(r) + args.new_tokens) // ps) for r in conc)
    tight2 = npu_hierarchy(
        lpddr6(capacity_gb=(need // 4 + 0.5) * pb / 1e9),
        hbs(1e3, latency_us=0.0,
            capacity_gb=(need // 2 - need // 4 + 0.5) * pb / 1e9))
    return long_req, conc, tight2


@pytest.fixture(scope="module")
def sweep():
    """The reference's twin, weights (PRNGKey 0) and one-shard runs, the
    port's sections on the same weights with serialized streams, and the
    port's rank groups (2: mesh; 4: mesh and capacity)."""
    ref = _reference_module()
    args = tshard.parser().parse_args(["--device", "cpu"])
    cfg, opts, jp = ref._model(args)
    tp = tm.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    reqs = ref._workload(cfg, args)
    # the rank groups run in their own processes while the reference's
    # engine serves here
    with ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(tshard.run_groups, args, tp, False)
        ser, want = ref._run(cfg, jp, opts, reqs, args, overlap=False)
        long_req, conc, tight2 = _reference_capacity(cfg, args)
        _, want_long = ref._run(cfg, jp, opts, [long_req], args,
                                overlap=False)
        conc1, want_conc = ref._run(cfg, jp, opts, conc, args,
                                    hierarchy=tight2, max_batch=4,
                                    overlap=False)
        groups = spawned.result()
    with contextlib.redirect_stdout(io.StringIO()):
        got = dict(
            overlap=tshard.overlap_section(args, tp, want=want),
            mesh=tshard.mesh_section(args, tp, overlap=False, want=want,
                                     groups=groups),
            capacity=tshard.capacity_section(args, tp, overlap=False,
                                             groups=groups))
    return dict(cfg=cfg, args=args, ref=ref, ser=ser, want=want,
                want_long=want_long, conc1=conc1, want_conc=want_conc,
                groups=groups, got=got, reqs=reqs)


def test_twin_is_the_references(sweep):
    args = sweep["args"]
    assert dataclasses.asdict(tshard.twin_config(args)) == \
        dataclasses.asdict(sweep["cfg"])
    assert tshard._workload(sweep["cfg"], args) == sweep["reqs"]
    long_req, _, conc, _ = tshard._capacity_inputs(
        tshard.twin_config(args), tm.RuntimeOptions(dtype="float32"), args)
    assert (long_req, conc) == _reference_capacity(sweep["cfg"], args)[:2]


def test_overlap_section_equals_the_reference_engine(sweep):
    """Both streams' tokens are the reference engine's; serialized, its
    counters are too."""
    o = sweep["got"]["overlap"]
    assert o["token_identical"]
    s = sweep["ser"].stats
    assert o["serialized"]["counters"] == {k: getattr(s, k)
                                           for k in COUNTERS}
    for cell in (o["overlapped"], o["serialized"]):
        assert cell["trace_reconciled"] and cell["pages_left"] == 0
    assert set(o) == {"overlapped", "serialized", "token_identical",
                      "speedup", "overlap_beats_serialized"}


@pytest.mark.parametrize("n", [1, 2, 4])
def test_mesh_cells_give_the_one_shard_tokens(sweep, n):
    """At every shard count, on every rank, the reference's one-shard
    tokens, its counters, and a pool of 1/N the bytes."""
    mesh = sweep["got"]["mesh"]
    assert mesh["shard_counts"] == [1, 2, 4]
    c = mesh["cells"][f"mesh{n}"]
    assert c["token_identical"] and c["trace_reconciled"]
    s = sweep["ser"].stats
    assert c["counters"] == {k: getattr(s, k) for k in COUNTERS}
    assert c["pool_bytes"] * n == mesh["cells"]["mesh1"]["pool_bytes"]
    if n > 1:
        ranks = sweep["groups"][n]
        assert [r["mesh"]["outs"] for r in ranks] == [sweep["want"]] * n
        assert {r["mesh"]["backend"] for r in ranks} == {"gloo"}
        assert all(r["mesh"]["cell"]["pages_left"] == 0 for r in ranks)
    assert mesh["all_token_identical"]


def test_analytic_bridge_equals_the_reference():
    from repro.core import (TC, concurrent_inference, ddr_only, hbs,
                            lpddr6, npu_hierarchy, resident_bytes)
    big = get_config("llava15-13b")
    hier = npu_hierarchy(lpddr6(520.0, capacity_gb=32.0),
                         hbs(8.0, latency_us=20.0, capacity_gb=64.0))
    want = {}
    for n in (1, 2, 4):
        pt = concurrent_inference(big, hier, ddr_only(), n_concurrent=4,
                                  prefill_len=4096, decode_len=256,
                                  dtype_bytes=2, kv_shards=n)
        fp = resident_bytes(big, 4096 + 256, 4, 2)
        want[f"kv_shards{n}"] = {
            "kv_gb_per_chip": round(fp[TC.KV] / n / 1e9, 3),
            "aggregate_tps": round(pt.aggregate_tps, 3)}
    assert tshard.analytic_bridge() == want


def test_capacity_section(sweep):
    """The single device rejects the long request "across all" its tiers;
    four shards serve it token-identically to the reference's one-shard
    engine; serialized, the concurrent mix preempts at one shard (as the
    reference's engine does, counter for counter) and not at four."""
    c = sweep["got"]["capacity"]
    assert c["single_device_rejects"]
    assert c["mesh4_serves_token_identical"]
    ranks = sweep["groups"][4]
    assert [r["capacity_long"]["outs"] for r in ranks] == \
        [sweep["want_long"]] * 4
    assert c["mesh4_peak_fast_pages"] <= 6          # a device's budget
    s = sweep["conc1"].stats
    assert c["n1"]["counters"] == {k: getattr(s, k) for k in COUNTERS}
    assert c["n1"]["token_identical"] and c["n4"]["token_identical"]
    assert [r["capacity_conc"]["outs"] for r in ranks] == \
        [sweep["want_conc"]] * 4
    assert c["n1"]["preemptions"] > 0 == c["n4"]["preemptions"]
    assert c["mesh_relieves_pressure"]
    # a page a rank is 1/4 of the single device's: the same tiers hold
    # four times the pages
    assert c["n4"]["peak_fast_pages"] > c["n1"]["peak_fast_pages"]


def test_single_device_rejection_message(sweep):
    args = sweep["args"]
    cfg, opts = tshard.measured_model(args)
    long_req, tight, _, _ = tshard._capacity_inputs(cfg, opts, args)
    with pytest.raises(ValueError, match="across all"):
        tshard._run(cfg, None, opts, [long_req], args, hierarchy=tight,
                    overlap=False)


def test_cli_out_writes_the_printed_json(tmp_path, capsys):
    path = tmp_path / "out" / "shard_sweep.json"
    res = tshard.main(["--device", "cpu", "--out", str(path),
                       "--n-requests", "4", "--new-tokens", "4"])
    printed = capsys.readouterr().out
    text = path.read_text()
    assert printed.startswith(text)
    assert "[shard_sweep] gates: " in printed[len(text):]
    assert json.loads(text) == json.loads(json.dumps(res))
    assert set(res) == {"workload", "overlap", "mesh", "capacity"}
    assert res["overlap"]["token_identical"]
    assert res["mesh"]["all_token_identical"]
    assert set(res["mesh"]["cells"]) == {"mesh1", "mesh2", "mesh4"}
    assert res["capacity"]["single_device_rejects"]
    assert res["capacity"]["mesh4_serves_token_identical"]


def test_cli_defaults_to_cuda():
    assert tshard.parser().parse_args([]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with contextlib.redirect_stdout(io.StringIO()), \
            pytest.raises(RuntimeError, match="CUDA"):
        tshard.main([])
    with pytest.raises(RuntimeError, match="CUDA"):
        tshard.overlap_section(tshard.parser().parse_args([]))


def test_sweep_imports_only_the_port():
    text = (ROOT / "src" / "repro_torch" / "paper"
            / "shard_sweep.py").read_text()
    lines = [ln.strip() for ln in text.splitlines()]
    assert not [ln for ln in lines
                if ln.startswith(("import jax", "from jax", "import repro.",
                                  "from repro.", "from repro import",
                                  "from benchmarks", "import benchmarks"))]
    assert "BENCH_" not in text and "merge_bench_json" not in text
    assert "xla_force_host_platform_device_count" not in text


def test_card_model_at_full_width():
    """On the card: llama3.2-1b at full width, 4 of 16 layers, bf16; a
    page 262,144 B, 65,536 B a rank at four shards; the capacity tiers in
    pages of that size."""
    from repro_torch.models import kernel_width_reason
    args = tshard.parser().parse_args([])
    cfg, opts = tshard.measured_model(args)
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.n_layers, opts.dtype) == (2048, 32, 32, 64, 4, "bfloat16")
    assert kernel_width_reason(cfg, "paged") is None
    pb = tshard._page_nbytes(cfg, opts, args)
    assert pb == 262_144 and pb // 4 == 65_536
    twin = tshard.twin_config(args)
    assert all(not c.n_kv_heads % n for c in (cfg, twin) for n in (1, 2, 4))
    _, tight, _, tight2 = tshard._capacity_inputs(cfg, opts, args)
    _, ttight, _, ttight2 = tshard._capacity_inputs(
        twin, tm.RuntimeOptions(dtype="float32"),
        tshard.parser().parse_args(["--device", "cpu"]))
    tpb = tshard._page_nbytes(twin, tm.RuntimeOptions(dtype="float32"),
                              args)
    for h, t in ((tight, ttight), (tight2, ttight2)):
        # the DDR and HBS tiers (the scratchpad and L2 are fixed sizes)
        assert [lv.capacity / pb for lv in h.chain[2:]] == pytest.approx(
            [lv.capacity / tpb for lv in t.chain[2:]])
