"""TPS vs concurrency: runtime engine (static vs continuous) x analytical
(the reference's ``benchmarks/concurrency_sweep.py`` on the port).

The paper's capacity-pressure experiment, answerable for any hierarchy
preset: every concurrent request adds a full KV cache, so aggregate KV
grows linearly while the fast tiers don't. Two halves:

1. ANALYTICAL — ``repro_torch.core.concurrency`` sweeps a 1B-class config
   on the paper's NPU+HBS hierarchy and the bonded-SRAM-chiplet hierarchy,
   reporting aggregate/per-request TPS and the KV tier split as the
   ``capacity_aware`` policy starts spilling.
2. RUNTIME — the port's engine with the static bucketed scheduler vs the
   continuous paged scheduler over a ragged request stream (the continuous
   engine keeps slots busy as short requests retire; the static engine
   waits for each wave), and prefix sharing on a shared-document stream.
   On the CPU it serves the reference's reduced twin in f32; on the card
   llama3.2-1b at full width in bf16, since the twin's head width 16 is
   one no kernel takes (``models.kernel_width_reason``).

Run: PYTHONPATH=src python -m repro_torch.paper.concurrency_sweep
     [--skip-runtime] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.reduce import reduced
from repro_torch.core import (chiplet_qkv, concurrency_sweep, hbs,
                              kv_dedup_factor, lpddr6,
                              max_concurrency_without_spill, npu_hierarchy,
                              qkv_in_ddr, sram_chiplet)
from repro_torch.models import RuntimeOptions

ARCH = "llama3.2-1b"           # the paper's 1B-class subject
PREFILL, DECODE = 2048, 256
CONCURRENCY = (1, 2, 4, 8, 16, 32, 64)


def hierarchies():
    return (
        ("npu+hbs", npu_hierarchy(lpddr6(520.0), hbs(64.0, latency_us=20.0)),
         qkv_in_ddr()),
        ("npu+chiplet", npu_hierarchy(lpddr6(173.0),
                                      chiplet=sram_chiplet(512.0)),
         chiplet_qkv()),
    )


def analytical() -> None:
    cfg = get_config(ARCH)
    print(f"== analytical: {ARCH}  prefill={PREFILL} decode={DECODE} ==")
    for name, hier, place in hierarchies():
        limit = max_concurrency_without_spill(cfg, hier, place,
                                              prefill_len=PREFILL,
                                              decode_len=DECODE)
        print(f"\n-- {name} (placement={place.name}; "
              f"no-spill concurrency limit={limit})")
        print(f"{'n':>4} {'agg_tps':>10} {'tps/req':>9} {'kv_GB':>7} "
              f"{'spill':>6} {'bottleneck':>10}  kv tiers")
        for p in concurrency_sweep(cfg, hier, place,
                                   concurrency=CONCURRENCY,
                                   prefill_len=PREFILL, decode_len=DECODE):
            tiers = " ".join(f"{lv}:{fr:.2f}" for lv, fr in p.kv_locations)
            print(f"{p.n_concurrent:>4} {p.aggregate_tps:>10.1f} "
                  f"{p.per_request_tps:>9.2f} {p.kv_bytes/1e9:>7.2f} "
                  f"{p.kv_spill_frac:>6.2f} {p.bottleneck:>10}  {tiers}")


def runtime_model(device):
    """(config, options, label) the runtime halves serve on ``device``."""
    if torch.device(device).type == "cuda":
        return (get_config(ARCH), RuntimeOptions(dtype="bfloat16"),
                f"{ARCH} at full width, bf16")
    cfg = reduced(get_config(ARCH), d_model=128, n_layers=4, vocab=512)
    return (cfg, RuntimeOptions(dtype="float32"),
            f"reduced {ARCH} ({cfg.d_model}d x {cfg.n_layers}L)")


def _stats(st) -> dict:
    return dict(tps=st.tps, decode_steps=st.decode_steps,
                preemptions=st.preemptions,
                peak_pages_used=st.peak_pages_used,
                pages_deduped=st.pages_deduped,
                prefill_tokens_computed=st.prefill_tokens_computed,
                host_syncs=st.host_syncs, ttft_p50=st.ttft_p50,
                ttft_p95=st.ttft_p95, itl_p50=st.itl_p50,
                itl_p95=st.itl_p95, prefill_s=st.prefill_s,
                decode_s=st.decode_s)


def _serve_warm(eng, reqs, new_tokens):
    """Serve ``reqs`` twice, the first to warm the engine, and return the
    second serve's outputs (its stats are the engine's)."""
    eng.serve([r[:] for r in reqs], new_tokens)
    eng.stats.__init__()
    return eng.serve([r[:] for r in reqs], new_tokens)


def ragged_requests(vocab: int) -> dict:
    """{n: n prompts of 8-63 tokens} for n = 2, 4, 8, drawn in turn from
    one seeded stream (the lengths do not depend on ``vocab``)."""
    rng = np.random.default_rng(0)
    out = {}
    for n in (2, 4, 8):
        lens = rng.integers(8, 64, size=n)
        out[n] = [rng.integers(1, vocab, size=int(ln)).tolist()
                  for ln in lens]
    return out


def runtime(device="cuda", params=None) -> dict:
    """Static vs continuous over ragged prompts of 8-63 tokens at n = 2, 4,
    8 concurrent requests, 16 new tokens each. ``params``: the model's
    weights (default: the engine's seeded init). Returns {n: {"requests":
    ..., sched: {"tokens": ..., "stats": {...}}}}."""
    from repro_torch.serving import ServeEngine

    cfg, opts, label = runtime_model(device)
    new_tokens, max_len = 16, 96

    print(f"\n== runtime: {label} on {device}, ragged prompts, {new_tokens} "
          f"new tokens ==")
    print(f"{'n':>4} {'static_tps':>11} {'continuous_tps':>15} "
          f"{'steps_s/c':>10} {'preempt':>8} {'ttft_p50/p95_ms':>16} "
          f"{'itl_p50/p95_ms':>15}")
    out = {}
    for n, reqs in ragged_requests(cfg.vocab).items():
        res = {"requests": reqs}
        for sched in ("static", "continuous"):
            eng = ServeEngine(cfg, params, opts, device=device, seed=0,
                              max_len=max_len, scheduler=sched,
                              page_size=16, max_batch=8)
            params = eng.params              # one init for every engine
            # warm the engine so TPS compares steady-state decode
            toks = _serve_warm(eng, reqs, new_tokens)
            res[sched] = dict(tokens=toks, stats=_stats(eng.stats))
        s, c = res["static"]["stats"], res["continuous"]["stats"]
        print(f"{n:>4} {s['tps']:>11.1f} {c['tps']:>15.1f} "
              f"{s['decode_steps']:>4}/{c['decode_steps']:<4} "
              f"{c['preemptions']:>8} "
              f"{c['ttft_p50']*1e3:>7.1f}/{c['ttft_p95']*1e3:<8.1f} "
              f"{c['itl_p50']*1e3:>6.1f}/{c['itl_p95']*1e3:<8.1f}")
        out[n] = res
    return out


def shared_prefix_analytical() -> None:
    """Sharing-aware no-spill concurrency per hierarchy preset."""
    cfg = get_config(ARCH)
    print(f"\n== shared-prefix dedup: {ARCH} prefill={PREFILL} "
          f"decode={DECODE} (prefix = 75% of prompt) ==")
    pfx = int(PREFILL * 0.75)
    print(f"{'hier':>12} {'share_group':>12} {'dedup@8':>8} "
          f"{'no-spill limit':>15}")
    for name, hier, place in hierarchies():
        for g in (1, 4, 8):
            lim = max_concurrency_without_spill(
                cfg, hier, place, prefill_len=PREFILL, decode_len=DECODE,
                shared_prefix_len=pfx, share_group=g)
            f = kv_dedup_factor(8, PREFILL, DECODE,
                                shared_prefix_len=pfx, share_group=g)
            print(f"{name:>12} {g:>12} {f:>8.2f} {lim:>15}")


def shared_prefix_runtime(device="cuda", params=None) -> dict:
    """Measured dedup on a shared-document QA workload vs predicted: 6
    requests x (48-token document + 8-token question), 16 new tokens,
    prefix cache off and on. Returns {"requests": ..., False/True:
    {"tokens": ..., "stats": {...}}, "predicted": ..., "measured": ...}."""
    from repro_torch.serving import ServeEngine

    rcfg, opts, _ = runtime_model(device)
    rng = np.random.default_rng(1)
    doc = rng.integers(1, rcfg.vocab, size=48).tolist()
    reqs = [doc + rng.integers(1, rcfg.vocab, size=8).tolist()
            for _ in range(6)]
    print(f"\n-- runtime: 6 requests x (48-token doc + 8-token question), "
          f"16 new tokens")
    print(f"{'prefix_cache':>13} {'prefill_toks':>13} {'peak_pages':>11} "
          f"{'deduped':>8} {'ttft_p95_ms':>12}")
    out = {"requests": reqs}
    for pc in (False, True):
        eng = ServeEngine(rcfg, params, opts, device=device, seed=0,
                          max_len=96, scheduler="continuous", page_size=16,
                          max_batch=8, prefix_cache=pc)
        params = eng.params
        toks = _serve_warm(eng, reqs, 16)
        st = _stats(eng.stats)
        out[pc] = dict(tokens=toks, stats=st)
        print(f"{str(pc):>13} {st['prefill_tokens_computed']:>13} "
              f"{st['peak_pages_used']:>11} {st['pages_deduped']:>8} "
              f"{st['ttft_p95']*1e3:>12.1f}")
    out["predicted"] = kv_dedup_factor(6, 56, 16, shared_prefix_len=48,
                                       share_group=6)
    out["measured"] = (out[True]["stats"]["peak_pages_used"]
                       / max(out[False]["stats"]["peak_pages_used"], 1))
    print(f"   predicted KV dedup factor {out['predicted']:.2f} vs measured "
          f"peak-page ratio {out['measured']:.2f}")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip-runtime", action="store_true",
                    help="analytical table only (no serving)")
    ap.add_argument("--device", default="cuda",
                    help="where the runtime halves serve (default cuda)")
    args = ap.parse_args(argv)
    analytical()
    shared_prefix_analytical()
    if not args.skip_runtime:
        runtime(args.device)
        shared_prefix_runtime(args.device)


if __name__ == "__main__":
    main()
