"""Serving CLI of the PyTorch port, on the GPU by default: static waves
over a dense cache (the default, as in the reference CLI), or continuous
batching over the paged KV pool (greedy or sampled decoding, optionally
speculative).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
        --scheduler continuous --concurrency 16 --prompt-len 256 \\
        --new-tokens 64 --dtype bfloat16
    # static waves: one --batch x --prompt-len wave, or --concurrency
    # ragged requests bucketed by length
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \\
        --scheduler static --batch 4 --prompt-len 256 --dtype bfloat16

    # a small CPU run (the plain attention path instead of the kernels)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
        --reduced --scheduler continuous --concurrency 5 --device cpu
    # speculative decoding (n-gram draft), then sampling
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
        --reduced --device cpu --scheduler continuous --spec-mode ngram \\
        --spec-k 4 --shared-doc 12
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
        --reduced --device cpu --scheduler continuous --temperature 0.8 \\
        --top-p 0.9

    # a mixture-of-experts decoder, on either engine
    PYTHONPATH=src python -m repro_torch.launch.serve --arch arctic-480b \\
        --reduced --device cpu [--scheduler continuous]
    # a VLM decoder (no patches on the CLI: the first prefix_len prompt
    # tokens attend bidirectionally) or local:global layers, static only
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llava15-13b \\
        --reduced --device cpu
    # MLA with a dense first layer, Mamba-2, the Zamba2 hybrid: static only
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch deepseek-v2-236b --reduced --device cpu

    # head-sharded continuous serving: 2 ranks spawned here, each holding
    # half the KV heads of every page (one card each where there are two,
    # else both on one card, or the CPU, over gloo)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
        --reduced --device cpu --scheduler continuous --shards 2

The flags and their destinations are the reference CLI's
(``repro/launch/serve.py``). What the reference's paged path refuses
(every family but the dense and MoE GQA decoders, and sliding-window and
soft-capped configs, under ``--scheduler continuous``) is rejected by the
engine with ``NotImplementedError``; ``--shards`` > 1 off the continuous
engine, or not dividing the KV heads, with ``ValueError``. An
encoder-decoder (whisper-medium) needs frame embeddings, which the CLI has
no flag for (nor has the reference's): it raises ``ValueError``.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.configs.reduce import reduced
from repro_torch.models import RuntimeOptions
from repro_torch.serving import ServeEngine

# a sharded run's collectives and the whole run time out after this long
RANK_TIMEOUT_S = 3600.0


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
    ap.add_argument("--scheduler", default="static",
                    choices=["static", "continuous"])
    ap.add_argument("--concurrency", type=int, default=0,
                    help="number of in-flight ragged requests "
                         "(0: --batch prompts of --prompt-len tokens)")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=8,
                    help="continuous scheduler slot count")
    ap.add_argument("--shards", type=int, default=1,
                    help="head-shard the paged KV pool and attention over "
                         "this many ranks (processes spawned here; each on "
                         "its own card where there are enough, else all on "
                         "one card or the CPU over gloo)")
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
                    help="speculative decoding: 'ngram' drafts by prompt "
                         "lookup (model-free), 'model' drafts with a small "
                         "paged-KV model (--draft-config)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="max draft tokens verified per pass (the verify "
                         "window is K+1 wide; acceptance-adaptive per "
                         "request)")
    ap.add_argument("--draft-config",
                    help="arch name for the --spec-mode model draft "
                         "(reduced with --d-model/2 when --reduced)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0: greedy). Draws are made "
                         "on the device from per-request counters; with "
                         "spec decoding, leftover/rejection sampling keeps "
                         "the output distribution exact")
    ap.add_argument("--top-k", type=int, default=0,
                    help="top-k logit filter (0: off; needs --temperature)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus filter (1.0: off; needs --temperature)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights, the request stream and the "
                         "per-request sampling draws")
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
    if args.chiplet_mb is not None and args.kv_fast_mb is None:
        ap.error("--chiplet-mb needs --kv-fast-mb (the chiplet promotes "
                 "out of the tiered KV pool)")
    if args.shards > 1:
        # one process a shard, each a rank of one process group; the
        # engine validates the rest (continuous scheduler, n_kv_heads)
        from repro_torch.launch.ranks import backend_for, run_ranks
        run_ranks(_serve, args.shards, (args,),
                  backend=backend_for(args.shards, args.device),
                  timeout=RANK_TIMEOUT_S)
    else:
        _serve(0, args)


def _serve(rank: int, args) -> None:
    """Build the engine, serve the request stream and, in rank 0, print
    the report (a head-sharded run calls this in every rank)."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg, d_model=args.d_model)
    draft_cfg = None
    if args.draft_config:
        draft_cfg = get_config(args.draft_config)
        if args.reduced:
            draft_cfg = reduced(draft_cfg, d_model=max(args.d_model // 2, 16))
    max_len = args.prompt_len + args.new_tokens + args.shared_doc
    hier = None
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

    if cfg.family == "encdec":
        # the reference's CLI passes no frames either, and its encoder
        # then fails on None (AttributeError); say why here instead
        raise ValueError(
            f"{cfg.name} is an encoder-decoder: this CLI has no frame "
            f"embeddings (prefix_emb) to encode; serve it through "
            f"ServeEngine.generate(prompts, n, prefix_emb=frames)")
    rng = np.random.default_rng(args.seed)
    doc = rng.integers(1, cfg.vocab, size=args.shared_doc).tolist()
    if args.concurrency:
        # ragged request stream: lengths in [prompt_len // 2, prompt_len]
        lens = rng.integers(max(args.prompt_len // 2, 1),
                            args.prompt_len + 1, size=args.concurrency)
    else:
        lens = [args.prompt_len] * args.batch
    reqs = [doc + rng.integers(1, cfg.vocab, size=n).tolist() for n in lens]
    if args.scheduler == "static" and not args.concurrency:
        outs = eng.generate(np.asarray(reqs), args.new_tokens)
    else:
        outs = eng.serve(reqs, args.new_tokens)
    if eng.shard is not None:
        import torch.distributed as dist
        devices = [None] * eng.shard.size
        dist.all_gather_object(devices, str(eng.device))
        if rank == 0:
            print(f"[serve] shards={eng.shard.size} "
                  f"backend={dist.get_backend()} ranks: "
                  + " ".join(f"{r}->{d}" for r, d in enumerate(devices)))
    if rank:
        return
    s = eng.stats
    print(f"[serve] arch={cfg.name} device={eng.device} "
          f"sched={args.scheduler} kv={args.kv_policy} reqs={s.requests} "
          f"prefill={s.prefill_s*1e3:.0f}ms decode={s.decode_s*1e3:.0f}ms "
          f"serve={s.serve_s*1e3:.0f}ms "
          f"steps={s.decode_steps} lookahead={args.decode_lookahead} "
          f"syncs={s.host_syncs} preempt={s.preemptions} TPS={s.tps:.1f} "
          f"shards={args.shards} overlap={not args.no_overlap}")
    if args.scheduler == "continuous":
        _print_continuous(args, eng, hier)
    print("[serve] first output:", outs[0][:16])


def _print_continuous(args, eng, hier) -> None:
    """The continuous engine's prefix-cache, offload, speculation and
    trace reports."""
    s = eng.stats
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
    if args.spec_mode != "off":
        print(f"[serve] spec: mode={args.spec_mode} k={args.spec_k} "
              f"blocks={s.spec_blocks} proposed={s.draft_proposed} "
              f"accepted={s.draft_accepted} "
              f"accept_rate={s.acceptance_rate:.0%}")
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


if __name__ == "__main__":
    main()
