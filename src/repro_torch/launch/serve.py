"""Serving CLI of the PyTorch port: continuous batching over the paged KV
pool, greedy decoding, on the GPU by default.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
        --scheduler continuous --concurrency 16 --prompt-len 256 \\
        --new-tokens 64 --dtype bfloat16

    # a small CPU run (the plain attention path instead of the kernels)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
        --reduced --concurrency 5 --device cpu

The flags and their destinations are the reference CLI's
(``repro/launch/serve.py``). Options this slice does not run yet
(``--scheduler static``, ``--spec-mode``, ``--temperature``/``--top-k``/
``--top-p``, ``--shards`` > 1) are rejected by the engine with
``NotImplementedError``.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.configs.reduce import reduced
from repro_torch.models import RuntimeOptions
from repro_torch.serving import ServeEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model and KV pool live (default: the "
                         "GPU; 'cpu' runs the kernels' plain versions)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--kv-policy", default="native",
                    choices=["native", "int8"])
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--scheduler", default="continuous",
                    choices=["static", "continuous"])
    ap.add_argument("--concurrency", type=int, default=0,
                    help="number of in-flight ragged requests "
                         "(0: --batch prompts of --prompt-len tokens)")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=8,
                    help="continuous scheduler slot count")
    ap.add_argument("--shards", type=int, default=1,
                    help="head-shard the paged KV pool (not ported yet)")
    ap.add_argument("--no-overlap", action="store_true",
                    help="serialize the prefill and decode streams onto "
                         "one virtual queue instead of overlapping them")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="tokens per prefill chunk (default 2 pages, min 32)")
    ap.add_argument("--prefill-budget", type=int, default=None,
                    help="max prefill tokens per engine step")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable shared-prefix KV page reuse")
    ap.add_argument("--decode-lookahead", type=int, default=8,
                    help="fused decode block size K: greedy tokens are "
                         "chosen on the device and pulled to the host once "
                         "per K steps; K=1 reproduces the per-token loop "
                         "and any K is token-identical (default: 8)")
    ap.add_argument("--spec-mode", default="off",
                    choices=["off", "ngram", "model"],
                    help="speculative decoding (not ported yet)")
    ap.add_argument("--spec-k", type=int, default=4)
    ap.add_argument("--draft-config",
                    help="arch of the --spec-mode model draft (not ported)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (only 0, greedy, is ported)")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights and of the request stream")
    ap.add_argument("--shared-doc", type=int, default=0,
                    help="prepend a shared document of this many tokens to "
                         "every request (exercises prefix dedup)")
    ap.add_argument("--kv-fast-mb", type=float, default=None,
                    help="cap the fast KV tier (DDR) at this many MB and "
                         "offload the overflow to simulated HBS (page "
                         "residency, spill/prefetch and stall accounting)")
    ap.add_argument("--hbs-gb", type=float, default=64.0,
                    help="HBS offload tier capacity in GB")
    ap.add_argument("--hbs-gbps", type=float, default=None,
                    help="override HBS bandwidth (GB/s) for migration timing")
    ap.add_argument("--hbs-us", type=float, default=None,
                    help="override HBS issue latency (µs)")
    ap.add_argument("--chiplet-mb", type=float, default=None,
                    help="bond a promote-only SRAM chiplet buffer of this "
                         "many MB in front of the fast KV tier (needs "
                         "--kv-fast-mb)")
    ap.add_argument("--chiplet-gbps", type=float, default=None,
                    help="override the chiplet link bandwidth (GB/s)")
    ap.add_argument("--chiplet-us", type=float, default=None,
                    help="override the chiplet link issue latency (µs)")
    ap.add_argument("--layer-overlap", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="slice each demand fetch per layer and pipeline the "
                         "slices against the layer loop; --no-layer-overlap "
                         "restores the whole-block fetch barrier")
    ap.add_argument("--writeback-link", default="dedicated",
                    choices=["shared", "dedicated"],
                    help="'dedicated': dirty-page write-back rides its own "
                         "out channel; 'shared': spills and fetches contend "
                         "for one half-duplex offload link")
    ap.add_argument("--trace-out", default=None,
                    help="write the run's Chrome trace-event JSON here")
    ap.add_argument("--slo-ttft-ms", type=float, default=None,
                    help="TTFT target: print the goodput report")
    ap.add_argument("--slo-itl-ms", type=float, default=None,
                    help="per-request p95 inter-token-latency target")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg, d_model=args.d_model)
    draft_cfg = get_config(args.draft_config) if args.draft_config else None
    max_len = args.prompt_len + args.new_tokens + args.shared_doc
    hier = None
    if args.chiplet_mb is not None and args.kv_fast_mb is None:
        ap.error("--chiplet-mb needs --kv-fast-mb (the chiplet promotes "
                 "out of the tiered KV pool)")
    if args.kv_fast_mb is not None:
        from repro_torch.core import hbs, lpddr6, npu_hierarchy, sram_chiplet
        chiplet = None
        if args.chiplet_mb is not None:
            chiplet = sram_chiplet(args.chiplet_gbps or 512.0,
                                   capacity_mb=args.chiplet_mb)
        hier = npu_hierarchy(
            lpddr6(capacity_gb=args.kv_fast_mb / 1e3),
            hbs(args.hbs_gbps or 8.0, latency_us=args.hbs_us or 20.0,
                capacity_gb=args.hbs_gb),
            chiplet=chiplet)
    eng = ServeEngine(cfg, opts=RuntimeOptions(dtype=args.dtype),
                      device=args.device, seed=args.seed,
                      kv_policy=args.kv_policy, max_len=max_len,
                      scheduler=args.scheduler, page_size=args.page_size,
                      max_batch=args.max_batch,
                      prefill_chunk=args.prefill_chunk,
                      prefill_budget=args.prefill_budget,
                      prefix_cache=not args.no_prefix_cache,
                      decode_lookahead=args.decode_lookahead,
                      hierarchy=hier, hbs_gbps=args.hbs_gbps,
                      hbs_latency_us=args.hbs_us,
                      spec_mode=args.spec_mode, spec_k=args.spec_k,
                      draft_cfg=draft_cfg, temperature=args.temperature,
                      top_k=args.top_k, top_p=args.top_p,
                      sample_seed=args.seed,
                      shards=args.shards, overlap=not args.no_overlap,
                      chiplet_gbps=args.chiplet_gbps,
                      chiplet_latency_us=args.chiplet_us,
                      layer_overlap=args.layer_overlap,
                      writeback_link=args.writeback_link)

    rng = np.random.default_rng(args.seed)
    doc = rng.integers(1, cfg.vocab, size=args.shared_doc).tolist()
    if args.concurrency:
        # ragged request stream: lengths in [prompt_len // 2, prompt_len]
        lens = rng.integers(max(args.prompt_len // 2, 1),
                            args.prompt_len + 1, size=args.concurrency)
    else:
        lens = [args.prompt_len] * args.batch
    reqs = [doc + rng.integers(1, cfg.vocab, size=n).tolist() for n in lens]
    outs = eng.serve(reqs, args.new_tokens)
    s = eng.stats
    print(f"[serve] arch={cfg.name} device={eng.device} "
          f"sched={args.scheduler} kv={args.kv_policy} reqs={s.requests} "
          f"prefill={s.prefill_s*1e3:.0f}ms decode={s.decode_s*1e3:.0f}ms "
          f"serve={s.serve_s*1e3:.0f}ms "
          f"steps={s.decode_steps} lookahead={args.decode_lookahead} "
          f"syncs={s.host_syncs} preempt={s.preemptions} TPS={s.tps:.1f} "
          f"overlap={not args.no_overlap}")
    print(f"[serve] prefill_toks={s.prefill_tokens_computed} "
          f"cached={s.cached_prefix_tokens} deduped={s.pages_deduped} "
          f"cow={s.cow_copies} compiles={s.prefill_compiles} "
          f"ttft_p50/p95={s.ttft_p50*1e3:.1f}/{s.ttft_p95*1e3:.1f}ms "
          f"itl_p50/p95={s.itl_p50*1e3:.1f}/{s.itl_p95*1e3:.1f}ms")
    if hier is not None:
        # peak KV footprint priced at the ACTIVE cache width
        peak_mb = s.peak_pages_used * eng.page_nbytes / 1e6
        fast_mb = s.peak_fast_pages * eng.page_nbytes / 1e6
        print(f"[serve] offload: stall={s.stall_s*1e3:.1f}ms "
              f"spilled={s.pages_spilled}p/{s.spill_bytes/1e6:.2f}MB "
              f"fetched={s.pages_fetched}p/{s.fetch_bytes/1e6:.2f}MB "
              f"prefetch_hit={s.prefetch_hit_rate:.0%} "
              f"kv_width={eng.kv_dtype_bytes}B "
              f"peak_kv={peak_mb:.2f}MB (fast {fast_mb:.2f}MB)")
        print(f"[serve] overlap: layer_overlap={args.layer_overlap} "
              f"stall_saved={s.stall_saved_s*1e3:.1f}ms "
              f"writeback={args.writeback_link} "
              f"clean_demotions={s.clean_demotions}")
        if args.chiplet_mb is not None:
            chan = " ".join(f"{k}={v/1e6:.2f}MB" for k, v
                            in sorted(s.channel_bytes.items()))
            print(f"[serve] chiplet: {args.chiplet_mb:g}MB "
                  f"hit_rate={s.chiplet_hit_rate:.0%} "
                  f"promoted={s.chiplet_promotions}p "
                  f"demoted={s.chiplet_demotions}p channels[{chan}]")
    # ---- structured trace exports ---- #
    agg = eng.trace.aggregate_breakdown_ms()
    print("[serve] time breakdown: " + " ".join(
        f"{p}={agg[f'{p}_ms']:.1f}ms"
        for p in ("queue", "prefill", "recompute", "decode", "stall",
                  "draft")))
    if args.slo_ttft_ms is not None or args.slo_itl_ms is not None:
        rep = eng.trace.slo_report(
            None if args.slo_ttft_ms is None else args.slo_ttft_ms * 1e-3,
            None if args.slo_itl_ms is None else args.slo_itl_ms * 1e-3)
        print(f"[serve] goodput: {rep['n_met_slo']}/{rep['n_requests']} met "
              f"SLO (frac={rep['goodput_frac']:.2f})")
        for v in rep["violators"][:6]:
            print(f"[serve]   violator r{v['rid']}: "
                  f"ttft={v['ttft_ms']:.1f}ms "
                  f"itl_p95={v['itl_p95_ms']:.1f}ms blame={v['blame']}")
    if args.trace_out:
        eng.trace.save(args.trace_out)
        print(f"[serve] wrote trace {args.trace_out} "
              f"(reconciled={eng.trace_report['ok']})")
    print("[serve] first output:", outs[0][:16])


if __name__ == "__main__":
    main()
