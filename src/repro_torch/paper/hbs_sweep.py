"""HBS interactivity sweep: the paper's requirement table, both halves
(the reference's ``benchmarks/hbs_sweep.py`` on the port; DESIGN.md SS13).

The paper's headline large-model scenario is a 13B-class model whose
long-context KV spills past the fast tiers into High Bandwidth Storage;
the question it answers is what bandwidth/latency envelope HBS must hit
for decode to stay interactive. This module reproduces that table twice
over a bandwidth x latency grid:

* **analytic_13b** — the hierarchical roofline model at FULL llava1.5-13B
  scale and long context (``core.concurrency.hbs_interactivity_sweep``):
  predicted TPS, per-token ITL and KV spill fraction per (GB/s, µs) cell,
  the minimum-bandwidth requirement readout per ITL target, and its
  spec-compounded variant (DESIGN.md SS14). CPU arithmetic on any device.
* **measured_reduced** — the port's serve engine with per-page tier
  residency and the ``SimulatedTierDevice`` charging migrations over the
  grid: TPS, ITL p50/p95, recorded decode stall, spill/fetch traffic and
  prefetch hit rate. At generous bandwidth the offload path must be
  token-identical to the no-offload path with zero recorded stall, and
  the runtime-observed ``kv_split_at_peak`` is pinned back into
  ``concurrent_inference`` (predicted_from_runtime_split).

"Measured" means simulated tiers and real step times: the kernels run on
the device and each block's measured wall time is charged to the
engine's virtual clock, while every page migration is charged there at
the swept bandwidth and latency; no page crosses a real link. On the CPU
the measured half serves the reference's reduced twin in f32. On the
card it serves llava15-13b's language decoder as a dense text decoder at
full width in bf16 (``measured_model``), cut in depth, since the twin's
head width 16 is one no kernel takes (``models.kernel_width_reason``).
Its pages are ``bw_scale`` times the twin's, and so is every swept
bandwidth: a page takes as long to move as the twin's. Each engine
serves the requests twice and reports the second serve, as the
reference does to warm its jit; on the card the first serve warms the
caching allocator and the kernels' first launches instead.

Run: PYTHONPATH=src python -m repro_torch.paper.hbs_sweep
     [--device cuda|cpu] [--out PATH]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.reduce import reduced
from repro_torch.paper.common import goodput_summary, schedule_counters

# generous-bandwidth grid point: transfers complete in sub-µs virtual
# time, so recorded stall must round to zero and prefetch always wins
GENEROUS_GBPS = 1e6
# llava15-13b's decoder layers the card serves (of 40), for time
CARD_LAYERS = 5
PAGE_SIZE = 16


def analytic_section(args) -> dict:
    from repro_torch.core import (TC, ddr_only, hbs, hbs_interactivity_sweep,
                                  lpddr6, min_hbs_bandwidth_for_itl,
                                  npu_hierarchy, resident_bytes)

    cfg = get_config("llava15-13b")
    # DDR sized so the FP16 weights fit but the long-context KV does not.
    # capacity_aware alone would keep the (largest-class) KV on DDR and
    # stream the WEIGHTS from HBS instead; the paper's regime is the
    # opposite — weights stay hot on DDR, the KV overflow spills — so pin
    # the KV split explicitly: fast share = whatever DDR has left after
    # the non-KV residents, remainder on HBS.
    ddr_gb = 32.0
    hier = npu_hierarchy(lpddr6(520.0, capacity_gb=ddr_gb),
                         hbs(8.0, latency_us=20.0))
    fp = resident_bytes(cfg, args.context + 256, 1, 2)
    kv_bytes = fp[TC.KV]
    non_kv = sum(v for c, v in fp.items() if c != TC.KV)
    kv_fast = min(max(ddr_gb * 1e9 - non_kv, 0.0) / kv_bytes, 1.0)
    kv_split = ((("ddr", kv_fast),) if kv_fast >= 1.0 else
                (("ddr", kv_fast), ("hbs", 1.0 - kv_fast)) if kv_fast > 0
                else (("hbs", 1.0),))
    bw = [float(x) for x in args.bw_gbps.split(",")]
    lat = [float(x) for x in args.latency_us.split(",")]
    grid = hbs_interactivity_sweep(cfg, hier, ddr_only(),
                                   bw_gbps=bw, latency_us=lat,
                                   prefill_len=args.context,
                                   decode_len=256, dtype_bytes=2,
                                   kv_split=kv_split)
    cells = [{
        "bw_gbps": g.bw_gbps,
        "latency_us": g.latency_us,
        "tps": round(g.tps, 3),
        "itl_ms": round(g.itl_s * 1e3, 3),
        "kv_spill_frac": round(g.kv_spill_frac, 3),
        "bottleneck": g.point.bottleneck,
    } for g in grid]
    req = {f"itl<={int(t * 1e3)}ms":
           {f"{lat_us:g}us": (bw_min if bw_min != float("inf") else None)
            for lat_us, bw_min in
            min_hbs_bandwidth_for_itl(grid, t).items()}
           for t in (0.05, 0.25, 1.0)}
    # spec-compounded envelope (DESIGN.md SS14): every verify pass streams
    # the spilled KV once but lands E(alpha, k) tokens, so the SAME ITL
    # target is met at LOWER HBS bandwidth — the two techniques compound
    from repro_torch.core import expected_tokens_per_pass
    e_tok = expected_tokens_per_pass(args.spec_alpha, args.spec_k)
    req_spec = {f"itl<={int(t * 1e3)}ms":
                {f"{lat_us:g}us": (bw_min if bw_min != float("inf")
                                   else None)
                 for lat_us, bw_min in
                 min_hbs_bandwidth_for_itl(
                     grid, t, tokens_per_pass=e_tok).items()}
                for t in (0.05, 0.25, 1.0)}
    shifts_down = any(
        (req[k][c] or float("inf")) > (req_spec[k][c] or float("inf"))
        for k in req for c in req[k]
        if req[k][c] is not None or req_spec[k][c] is not None)
    return {"arch": cfg.name, "context": args.context,
            "kv_gb": round(kv_bytes / 1e9, 2),
            "kv_fast_frac": round(kv_fast, 4),
            "grid": cells, "min_bw_gbps_for_target": req,
            "spec_compounded": {
                "alpha": args.spec_alpha, "k": args.spec_k,
                "tokens_per_pass": round(e_tok, 3),
                "min_bw_gbps_for_target": req_spec,
                "envelope_shifts_down": shifts_down,
            }}


def twin_config():
    """The reference's reduced dense twin of the 13B config."""
    return dataclasses.replace(
        reduced(get_config("llava15-13b"), d_model=128, n_layers=4,
                vocab=512),
        family="dense", prefix_len=0, source_len=0,
        name="llava15-13b-reduced-dense")


def measured_model(device):
    """(config, options) the measured half serves on ``device``: the twin
    in f32 on the CPU; on the card llava15-13b's language decoder as a
    dense text decoder at full width (d_model 5,120, 40 heads of 128 over
    40 KV heads, d_ff 20,480, vocab 32,000), bf16, ``CARD_LAYERS`` of its
    40 layers."""
    from repro_torch.models import RuntimeOptions
    if torch.device(device).type == "cuda":
        cfg = dataclasses.replace(get_config("llava15-13b"), family="dense",
                                  prefix_len=0, source_len=0,
                                  n_layers=CARD_LAYERS,
                                  name=f"llava15-13b-dense-{CARD_LAYERS}L")
        return cfg, RuntimeOptions(dtype="bfloat16")
    return twin_config(), RuntimeOptions(dtype="float32")


def measured_section(args, params=None, overlap: bool = True) -> dict:
    """The measured half on ``args.device``. ``params``: the model's
    weights (default: the engine's seeded init, shared by every engine);
    ``overlap``: the engines' prefill/decode stream overlap (the engine's
    default on; off, the schedule and every page counter follow the
    requests alone, not the measured step times)."""
    from repro_torch.core import concurrent_inference, ddr_only, hbs, \
        lpddr6, npu_hierarchy
    from repro_torch.models import torch_dtype
    from repro_torch.serving import ServeEngine
    from repro_torch.serving.kv_manager import page_bytes

    cfg, opts = measured_model(args.device)
    page_size = PAGE_SIZE
    # the pool's own element width: a bf16 tier holds twice the f32 pages
    dtype_bytes = torch_dtype(opts.dtype).itemsize
    pb = page_bytes(cfg, page_size, dtype_bytes)
    bw_scale = pb / page_bytes(twin_config(), page_size, 4)

    rng = np.random.default_rng(0)
    reqs = [rng.integers(1, cfg.vocab, size=n).tolist()
            for n in (args.prompt_len, args.prompt_len,
                      args.prompt_len // 2, args.prompt_len // 2)]
    max_len = args.prompt_len + args.new_tokens
    common = dict(device=args.device, seed=0, max_len=max_len,
                  scheduler="continuous", page_size=page_size, max_batch=4,
                  prefix_cache=True, overlap=overlap)

    # no-offload baseline: the token-identity reference
    base = ServeEngine(cfg, params, opts, **common)
    params = base.params                  # one init for every engine
    base.serve([r[:] for r in reqs], args.new_tokens)      # warm
    base.stats.__init__()
    want = base.serve([r[:] for r in reqs], args.new_tokens)

    # fast tier holds ~1/3 of the aggregate KV; the rest lives in HBS
    total_pages = sum(-(-(len(r) + args.new_tokens) // page_size)
                      for r in reqs)
    fast_pages = max(total_pages // 3, 2)
    hier = npu_hierarchy(lpddr6(capacity_gb=fast_pages * pb / 1e9),
                         hbs(8.0, latency_us=20.0, capacity_gb=1.0))

    twin_bw = [float(x) for x in args.measured_bw_gbps.split(",")]
    bw_grid = [round(bw * bw_scale, 12) for bw in twin_bw]
    bw_grid.append(GENEROUS_GBPS)
    lat_grid = [float(x) for x in args.measured_latency_us.split(",")]
    cells = []
    for bw in bw_grid:
        for lat in ([0.0] if bw == GENEROUS_GBPS else lat_grid):
            eng = ServeEngine(cfg, params, opts, **common, hierarchy=hier,
                              hbs_gbps=bw, hbs_latency_us=lat)
            eng.serve([r[:] for r in reqs], args.new_tokens)  # warm
            eng.stats.__init__()
            outs = eng.serve([r[:] for r in reqs], args.new_tokens)
            s = eng.stats
            slo = eng.trace.slo_report(args.slo_ttft_ms * 1e-3,
                                       args.slo_itl_ms * 1e-3)
            cells.append({
                "bw_gbps": bw, "latency_us": lat,
                "tps": round(s.tps, 2),
                "itl_p50_ms": round(s.itl_p50 * 1e3, 3),
                "itl_p95_ms": round(s.itl_p95 * 1e3, 3),
                "stall_ms": round(s.stall_s * 1e3, 3),
                "stall_by_rid_ms": {
                    str(rid): round(v * 1e3, 3)
                    for rid, v in sorted(s.stall_by_rid.items())},
                "spill_mb": round(s.spill_bytes / 1e6, 3),
                "fetch_mb": round(s.fetch_bytes / 1e6, 3),
                "prefetch_hit_rate": round(s.prefetch_hit_rate, 3),
                "peak_fast_pages": s.peak_fast_pages,
                "preemptions": s.preemptions,
                "token_identical": outs == want,
                "kv_split_at_peak": [[t, round(f, 4)]
                                     for t, f in s.kv_split_at_peak],
                # trace-derived (SS15): where each cell's time went, and
                # goodput vs the SLO targets with per-phase blame
                "breakdown_ms": eng.trace.aggregate_breakdown_ms(),
                "goodput": goodput_summary(slo),
                "trace_reconciled": eng.trace_report["ok"],
                "counters": schedule_counters(s, eng.page_nbytes),
            })

    generous = [c for c in cells if c["bw_gbps"] == GENEROUS_GBPS][0]
    stingiest = min(cells, key=lambda c: (c["bw_gbps"], -c["latency_us"]))
    # close the loop: pin the runtime-observed split into the analytical
    # model (the measured hierarchy prices it; TPS>0 proves the bridge)
    bridge = None
    if generous["kv_split_at_peak"]:
        split = tuple((t, f) for t, f in generous["kv_split_at_peak"])
        pt = concurrent_inference(cfg, hier, ddr_only(),
                                  n_concurrent=len(reqs),
                                  prefill_len=args.prompt_len,
                                  decode_len=args.new_tokens,
                                  dtype_bytes=dtype_bytes, kv_split=split)
        bridge = {"kv_split": generous["kv_split_at_peak"],
                  "predicted_tps": round(pt.aggregate_tps, 3)}
    return {
        "arch": cfg.name, "device": str(args.device),
        "dtype": opts.dtype, "n_layers": cfg.n_layers,
        "overlap": overlap, "n_requests": len(reqs),
        "prompt_len": args.prompt_len, "new_tokens": args.new_tokens,
        "fast_pages": fast_pages, "page_kb": round(pb / 1e3, 2),
        "bw_scale": bw_scale, "twin_bw_gbps": twin_bw,
        "slo_ttft_ms": args.slo_ttft_ms, "slo_itl_ms": args.slo_itl_ms,
        "grid": cells,
        "derived": {
            "goodput_generous": generous["goodput"]["goodput_frac"],
            "goodput_stingiest": stingiest["goodput"]["goodput_frac"],
            "generous_token_identical": generous["token_identical"],
            "generous_stall_ms": generous["stall_ms"],
            "all_token_identical": all(c["token_identical"] for c in cells),
            "all_traces_reconciled": all(c["trace_reconciled"]
                                         for c in cells),
            "stall_grows_as_bw_shrinks":
                stingiest["stall_ms"] > generous["stall_ms"],
            "predicted_from_runtime_split": bridge,
        },
    }


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where the measured half serves (default cuda)")
    ap.add_argument("--out", default=None,
                    help="also write the printed JSON to this file")
    ap.add_argument("--context", type=int, default=16384,
                    help="analytic long-context prefill length")
    ap.add_argument("--bw-gbps", default="2,8,32,128,520",
                    help="analytic HBS bandwidth grid (GB/s)")
    ap.add_argument("--latency-us", default="5,20,80",
                    help="analytic HBS latency grid (µs)")
    ap.add_argument("--measured-bw-gbps", default="0.002,0.02,0.2",
                    help="measured-engine HBS bandwidth grid at the twin's "
                         "page size (GB/s; scaled by bw_scale on the card; "
                         "a generous point is appended automatically)")
    ap.add_argument("--measured-latency-us", default="20,2000",
                    help="measured-engine HBS latency grid (µs)")
    ap.add_argument("--prompt-len", type=int, default=96)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--spec-alpha", type=float, default=0.7,
                    help="assumed per-position draft acceptance for the "
                         "spec-compounded analytic envelope")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="draft length for the spec-compounded envelope")
    ap.add_argument("--slo-ttft-ms", type=float, default=2000.0,
                    help="TTFT target for the per-cell goodput report")
    ap.add_argument("--slo-itl-ms", type=float, default=100.0,
                    help="per-request p95 ITL target for the per-cell "
                         "goodput report")
    return ap


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    results = {"analytic_13b": analytic_section(args),
               "measured_reduced": measured_section(args)}
    text = json.dumps(results, indent=2)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    return results


if __name__ == "__main__":
    main()
