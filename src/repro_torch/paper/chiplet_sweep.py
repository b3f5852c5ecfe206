"""Chiplet global-buffer sweep: chiplet size x migration policy, both
halves (the reference's ``benchmarks/chiplet_sweep.py`` on the port;
DESIGN.md SS17).

The paper's bonded-SRAM-chiplet lever puts a small, very fast buffer in
front of the constrained platform's DDR; this module asks what that buys
a 1B-class on-device model whose long-context KV spills to HBS:

* **analytic_1b** — the hierarchical roofline at FULL llama3.2-1b scale
  (``core.concurrency.chiplet_interactivity_sweep``): the HBS bandwidth x
  latency interactivity grid with the chiplet's steady-state hit fraction
  absorbing its share of the KV streaming, per swept chiplet capacity.
  The readout is the minimum-HBS-bandwidth envelope per ITL target —
  which must shift DOWN (never up) as the chiplet grows — plus the
  int8-KV x chiplet compounded envelope (``compounded_offload_envelope``).
* **measured_reduced** — the port's serve engine over a chiplet-pages x
  policy grid (layer-overlap vs whole-block barrier, dedicated vs shared
  write-back link): recorded stall, the within-run counterfactual barrier
  stall (``stall + stall_saved``: what the SAME run would have charged
  without layer slicing, so the comparison is exact rather than
  cross-run-noisy), EMA promotion hit rate, promotion/demotion traffic
  per channel, and token identity against the no-offload reference.

"Measured" means simulated tiers and real step times, as in
``hbs_sweep``. On the CPU the measured half serves the reference's
reduced twin in f32; on the card llama3.2-1b at full width and all 16
layers in bf16 (so layer slicing has its 16 slices), whose pages are
``bw_scale`` times the twin's, as is the swept HBS bandwidth. Chiplet
sizes stay in pages. Each engine serves twice and reports the second
serve; on the card the first warms the allocator, not a compiler.

Run: PYTHONPATH=src python -m repro_torch.paper.chiplet_sweep
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

# generous-bandwidth point: transfers complete in sub-µs virtual time, so
# recorded stall must round to zero and outputs stay token-identical
GENEROUS_GBPS = 1e6
PAGE_SIZE = 16
POLICIES = (("overlap", "dedicated"), ("barrier", "dedicated"),
            ("overlap", "shared"))


def _envelope(grid, targets, **kw) -> dict:
    from repro_torch.core import min_hbs_bandwidth_for_itl
    return {f"itl<={int(t * 1e3)}ms":
            {f"{lat_us:g}us": (bw if bw != float("inf") else None)
             for lat_us, bw in
             min_hbs_bandwidth_for_itl(grid, t, **kw).items()}
            for t in targets}


def _le(a, b) -> bool:
    """None means 'no swept bandwidth met the target' (= +inf)."""
    return (a or float("inf")) <= (b or float("inf"))


def analytic_section(args) -> dict:
    from repro_torch.core import (TC, chiplet_interactivity_sweep,
                                  chiplet_kv_hit_frac,
                                  compounded_offload_envelope, ddr_only,
                                  hbs, lpddr6, npu_hierarchy, resident_bytes)

    cfg = get_config("llama3.2-1b")
    # DDR sized so the weights stay hot but only ~25% of the long-context
    # KV fits — the remainder streams from HBS, the regime where the
    # chiplet's hit fraction matters (same pinned-split setup as
    # hbs_sweep; see that module for why capacity_aware alone inverts it)
    ctx = args.context
    fp = resident_bytes(cfg, ctx + 256, 1, 2)
    kv_bytes = fp[TC.KV]
    non_kv = sum(v for c, v in fp.items() if c != TC.KV)
    kv_fast = 0.25
    ddr_gb = (non_kv + kv_fast * kv_bytes) / 1e9
    hier = npu_hierarchy(lpddr6(520.0, capacity_gb=ddr_gb),
                         hbs(8.0, latency_us=20.0))
    kv_split = (("ddr", kv_fast), ("hbs", 1.0 - kv_fast))
    bw = [float(x) for x in args.bw_gbps.split(",")]
    lat = [float(x) for x in args.latency_us.split(",")]
    sizes = [float(x) for x in args.chiplet_mb.split(",")]
    grid = chiplet_interactivity_sweep(cfg, hier, ddr_only(),
                                       chiplet_mb=sizes, bw_gbps=bw,
                                       latency_us=lat, prefill_len=ctx,
                                       decode_len=256, dtype_bytes=2,
                                       kv_split=kv_split)
    cells = [{
        "chiplet_mb": g.chiplet_mb,
        "hit_frac": round(g.hit_frac, 4),
        "bw_gbps": g.bw_gbps,
        "latency_us": g.latency_us,
        "tps": round(g.tps, 3),
        "itl_ms": round(g.itl_s * 1e3, 3),
        "kv_spill_frac": round(g.kv_spill_frac, 3),
    } for g in grid]

    # per-chiplet-size min-bandwidth envelope: each ChipletGridPoint
    # already folds its hit fraction into itl_s, so the plain readout
    # applied per size slice IS the chiplet-adjusted envelope
    targets = (0.05, 0.25, 1.0)
    by_size = {}
    for mb in sizes:
        sub = [g for g in grid if g.chiplet_mb == mb]
        by_size[f"{mb:g}MB"] = {
            "hit_frac": round(sub[0].hit_frac, 4),
            "min_bw_gbps_for_target": _envelope(sub, targets),
        }
    # gate: a growing hit fraction never RAISES any envelope entry and
    # strictly lowers at least one, relative to the chiplet-less slice
    base_env = by_size[f"{min(sizes):g}MB"]["min_bw_gbps_for_target"]
    never_worse, strictly_lower = True, False
    for mb in sizes:
        env = by_size[f"{mb:g}MB"]["min_bw_gbps_for_target"]
        h = by_size[f"{mb:g}MB"]["hit_frac"]
        for t in env:
            for c in env[t]:
                if h > 0 and not _le(env[t][c], base_env[t][c]):
                    never_worse = False
                if h > 0 and (env[t][c] or 0.0) < (base_env[t][c]
                                                   or float("inf")):
                    strictly_lower = True

    # the compounded readout: int8 KV halves the streamed bytes AND
    # doubles what fits in the chiplet — both enter the envelope
    mb_max = max(sizes)
    h8 = chiplet_kv_hit_frac(cfg, ctx + 256, chiplet_mb=mb_max,
                             dtype_bytes=1)
    compounded = {f"itl<={int(t * 1e3)}ms":
                  {f"{lat_us:g}us": (bw_min if bw_min != float("inf")
                                     else None)
                   for lat_us, bw_min in compounded_offload_envelope(
                       [g.base for g in grid if g.chiplet_mb == mb_max],
                       t, dtype_bytes=2, kv_dtype_bytes=1,
                       chiplet_hit_frac=h8).items()}
                  for t in targets}
    return {"arch": cfg.name, "context": ctx,
            "kv_mb": round(kv_bytes / 1e6, 1),
            "ddr_gb": round(ddr_gb, 3), "kv_fast_frac": kv_fast,
            "grid": cells, "by_chiplet_size": by_size,
            "int8_compounded": {
                "chiplet_mb": mb_max, "hit_frac": round(h8, 4),
                "min_bw_gbps_for_target": compounded},
            "derived": {
                "hit_frac_lowers_envelope_everywhere": never_worse,
                "hit_frac_strictly_lowers_somewhere": strictly_lower,
            }}


def twin_config():
    """The reference's reduced dense twin of the 1B config (4 layers, so
    layer slicing has layers to hide behind)."""
    return dataclasses.replace(
        reduced(get_config("llama3.2-1b"), d_model=128, n_layers=4,
                vocab=512),
        family="dense", prefix_len=0, source_len=0,
        name="llama3.2-1b-reduced-dense")


def measured_model(device):
    """(config, options) the measured half serves on ``device``: the twin
    in f32 on the CPU, llama3.2-1b at full width and depth in bf16 on the
    card."""
    from repro_torch.models import RuntimeOptions
    if torch.device(device).type == "cuda":
        return get_config("llama3.2-1b"), RuntimeOptions(dtype="bfloat16")
    return twin_config(), RuntimeOptions(dtype="float32")


def measured_section(args, params=None, overlap: bool = True) -> dict:
    """The measured half on ``args.device``; ``params`` and ``overlap`` as
    in ``hbs_sweep.measured_section``."""
    from repro_torch.core import hbs, lpddr6, npu_hierarchy, sram_chiplet
    from repro_torch.models import torch_dtype
    from repro_torch.serving import ServeEngine
    from repro_torch.serving.kv_manager import page_bytes

    cfg, opts = measured_model(args.device)
    page_size = PAGE_SIZE
    pb = page_bytes(cfg, page_size, torch_dtype(opts.dtype).itemsize)
    bw_scale = pb / page_bytes(twin_config(), page_size, 4)
    stingy = round(args.hbs_gbps * bw_scale, 12)

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
    base.serve([r[:] for r in reqs], args.new_tokens)       # warm
    base.stats.__init__()
    want = base.serve([r[:] for r in reqs], args.new_tokens)

    total_pages = sum(-(-(len(r) + args.new_tokens) // page_size)
                      for r in reqs)
    fast_pages = max(total_pages // 3, 2)
    chip_sizes = [int(x) for x in args.chiplet_pages.split(",")]

    def hier_for(chip_pages: int):
        chiplet = (sram_chiplet(512.0, capacity_mb=chip_pages * pb / 1e6)
                   if chip_pages else None)
        return npu_hierarchy(lpddr6(capacity_gb=fast_pages * pb / 1e9),
                             hbs(8.0, latency_us=20.0, capacity_gb=1.0),
                             chiplet=chiplet)

    def run(chip_pages: int, policy: str, link: str, bw: float,
            lat_us: float = 20.0) -> dict:
        eng = ServeEngine(cfg, params, opts, **common,
                          hierarchy=hier_for(chip_pages), hbs_gbps=bw,
                          hbs_latency_us=lat_us,
                          layer_overlap=(policy == "overlap"),
                          writeback_link=link)
        eng.serve([r[:] for r in reqs], args.new_tokens)    # warm
        eng.stats.__init__()
        outs = eng.serve([r[:] for r in reqs], args.new_tokens)
        s = eng.stats
        return {
            "chiplet_pages": chip_pages, "policy": policy,
            "writeback_link": link, "bw_gbps": bw,
            "tps": round(s.tps, 2),
            "stall_ms": round(s.stall_s * 1e3, 3),
            "stall_saved_ms": round(s.stall_saved_s * 1e3, 3),
            # what the SAME run's calls would have charged with the
            # whole-block barrier — the exact counterfactual
            "barrier_stall_ms": round(
                (s.stall_s + s.stall_saved_s) * 1e3, 3),
            "itl_p50_ms": round(s.itl_p50 * 1e3, 3),
            "itl_p95_ms": round(s.itl_p95 * 1e3, 3),
            "chiplet_hit_rate": round(s.chiplet_hit_rate, 4),
            "chiplet_promotions": s.chiplet_promotions,
            "chiplet_demotions": s.chiplet_demotions,
            "clean_demotions": s.clean_demotions,
            "spill_mb": round(s.spill_bytes / 1e6, 3),
            "fetch_mb": round(s.fetch_bytes / 1e6, 3),
            "prefetch_hit_rate": round(s.prefetch_hit_rate, 3),
            "channel_mb": {k: round(v / 1e6, 4)
                           for k, v in sorted(s.channel_bytes.items())},
            "token_identical": outs == want,
            "trace_reconciled": eng.trace_report["ok"],
            "n_layer_slices": eng.n_layer_slices,
            "breakdown_ms": eng.trace.aggregate_breakdown_ms(),
            "counters": schedule_counters(s, eng.page_nbytes),
            # exact, within one run: the stall and its counterfactual
            "stall_s": s.stall_s, "stall_saved_s": s.stall_saved_s,
        }

    cells = [run(cp, pol, link, stingy)
             for cp in chip_sizes for pol, link in POLICIES]
    generous = run(max(chip_sizes), "overlap", "dedicated", GENEROUS_GBPS,
                   lat_us=0.0)
    cells.append(generous)

    # gates: pair each overlap cell with its barrier twin (same chiplet
    # size, dedicated link, stingy bandwidth); the measured cross-run
    # comparison gets a small wall-clock-noise tolerance, while the
    # within-run counterfactual (stall <= barrier_stall) is exact
    pairs = []
    for cp in chip_sizes:
        o = next(c for c in cells
                 if c["chiplet_pages"] == cp and c["policy"] == "overlap"
                 and c["writeback_link"] == "dedicated"
                 and c["bw_gbps"] == stingy)
        b = next(c for c in cells
                 if c["chiplet_pages"] == cp and c["policy"] == "barrier"
                 and c["writeback_link"] == "dedicated")
        pairs.append({"chiplet_pages": cp,
                      "overlap_stall_ms": o["stall_ms"],
                      "barrier_run_stall_ms": b["stall_ms"],
                      "counterfactual_barrier_ms": o["barrier_stall_ms"],
                      "saved_ms": o["stall_saved_ms"]})
    tol = lambda b_ms: max(2.0, 0.05 * b_ms)
    overlap_le = all(
        p["overlap_stall_ms"] <= p["counterfactual_barrier_ms"] + 1e-9
        and p["overlap_stall_ms"]
        <= p["barrier_run_stall_ms"] + tol(p["barrier_run_stall_ms"])
        for p in pairs)
    hit = {c["chiplet_pages"]: c["chiplet_hit_rate"] for c in cells
           if c["policy"] == "overlap" and c["writeback_link"] == "dedicated"
           and c["bw_gbps"] == stingy}
    return {
        "arch": cfg.name, "device": str(args.device),
        "dtype": opts.dtype, "overlap": overlap,
        "n_requests": len(reqs),
        "prompt_len": args.prompt_len, "new_tokens": args.new_tokens,
        "fast_pages": fast_pages, "page_kb": round(pb / 1e3, 2),
        "n_layer_slices": cfg.n_layers, "hbs_gbps": stingy,
        "bw_scale": bw_scale, "twin_hbs_gbps": args.hbs_gbps,
        "grid": cells, "overlap_vs_barrier": pairs,
        "derived": {
            "all_token_identical": all(c["token_identical"]
                                       for c in cells),
            "all_traces_reconciled": all(c["trace_reconciled"]
                                         for c in cells),
            "overlap_le_barrier_everywhere": overlap_le,
            "overlap_strictly_lower_somewhere": any(
                p["saved_ms"] > 0.1 for p in pairs),
            "hit_rate_by_chiplet_pages": hit,
            "hit_rate_grows_with_chiplet": (
                hit[max(chip_sizes)] >= hit[min(chip_sizes)]),
            "generous_stall_ms": generous["stall_ms"],
        },
    }


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where the measured half serves (default cuda)")
    ap.add_argument("--out", default=None,
                    help="also write the printed JSON to this file")
    ap.add_argument("--context", type=int, default=4096,
                    help="analytic long-context prefill length")
    ap.add_argument("--bw-gbps", default="2,8,32,128",
                    help="analytic HBS bandwidth grid (GB/s)")
    ap.add_argument("--latency-us", default="5,20,80",
                    help="analytic HBS latency grid (µs)")
    ap.add_argument("--chiplet-mb", default="0,32,128,512",
                    help="analytic chiplet capacity grid (MB; 0 = none; "
                         "the 1B model's KV at the default context is "
                         "~570 MB, so the grid spans hit fractions from "
                         "~0.06 to ~0.9)")
    ap.add_argument("--chiplet-pages", default="0,2,6",
                    help="measured-engine chiplet sizes in KV pages")
    ap.add_argument("--hbs-gbps", type=float, default=0.005,
                    help="measured-engine stingy HBS bandwidth at the "
                         "twin's page size (GB/s; scaled by bw_scale on "
                         "the card; a generous point is appended "
                         "automatically)")
    ap.add_argument("--prompt-len", type=int, default=96)
    ap.add_argument("--new-tokens", type=int, default=24)
    return ap


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    results = {"analytic_1b": analytic_section(args),
               "measured_reduced": measured_section(args)}
    text = json.dumps(results, indent=2)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    return results


if __name__ == "__main__":
    main()
