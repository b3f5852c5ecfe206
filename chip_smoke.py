#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU. Run from the root of a checkout:

    python3 chip_smoke.py [--out results.json]

Phases (any failure exits non-zero before the result line):
  1. needs CUDA; prints the card's name and power limit (nvidia-smi);
     TF32 off for f32 matmuls and convolutions.
  2. builds both paged-attention kernels from ``src/repro_torch/kernels/
     csrc`` (nvcc, in parallel) and prints the build time and ptxas report.
  3. holds each kernel against its plain PyTorch version on the card at
     the serving path's shapes (page 16, head_dim 64, group 1 and 4, ragged
     lengths up to 576 over a shuffled page table with stale entries, a
     64-token chunk with scalar and per-sequence start; f32, bf16 and int8
     pools) and times kernel, plain version and, as a yardstick only,
     ``F.scaled_dot_product_attention`` on the gathered dense KV; prints
     each kernel's bound (bytes over 3.35 TB/s or operations over the
     type's peak, whichever is larger).
  4. serves llama3.2-1b at full width (bf16, the port's own seeded init)
     through ``ServeEngine(scheduler="continuous")``: 16 requests of 64-448
     prompt tokens, 8 sharing a 128-token document, 64 new tokens each,
     once with native and once with int8 KV. Both kernels' launch counters
     must rise, the trace must reconcile and every page must be freed.
     Then torch.profiler splits one fused decode block's time by kernel
     and gives the device's busy share of its wall time.
  5. in f32 at full width: the kernel path's logits agree with the CPU
     plain path on one prompt, and decode_lookahead 8 is token-identical
     to decode_lookahead 1.
Then prints the per-kernel JSON line and, last, the device JSON line.
"""
from __future__ import annotations

import argparse
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12                      # H100 SXM device memory
# dense peak operations/s by input type (H100 SXM data sheet): bf16/f16 on
# the tensor cores; f32 on the CUDA cores (TF32 is off)
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12}
PS, DH, H, MAX_LEN, C = 16, 64, 32, 576, 64


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def check(ok: bool, msg: str) -> None:
    """A failed phase: raise (the script then exits non-zero)."""
    if not ok:
        raise RuntimeError(f"[smoke] FAIL: {msg}")


def median_ms(torch, fn, iters: int = 30) -> float:
    """Median device time of one call. Each call is queued behind a 64 MB
    write that evicts the 50 MB L2 (a serving step finds its KV cold) and
    behind a spin kernel longer than the host takes to enqueue the call, so
    the two events bracket the device's work and not the host's."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin_cycles = int(max(4 * host_s, 1e-4) * 2e9)      # ~2 GHz SM clock
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for a, b in ev:
        flush.zero_()
        torch.cuda._sleep(spin_cycles)
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in ev)


# ------------------------------ phase 3 --------------------------------- #

def kernel_cases(torch, kern):
    """Inputs at the serving path's shapes. Yields (name, label, dtype
    name, kernel fn, plain fn, sdpa fn, bytes, ops, tolerance)."""
    import torch.nn.functional as F
    dev = "cuda"
    B = 8
    n_pp = -(-MAX_LEN // PS)
    P = B * n_pp + 1
    g = torch.Generator(device=dev).manual_seed(0)
    for Hkv in (32, 8):
        for pool in ("float32", "bfloat16", "int8"):
            qdt = torch.float32 if pool == "float32" else torch.bfloat16
            kf = torch.randn((P, PS, Hkv, DH), generator=g, device=dev)
            vf = torch.randn((P, PS, Hkv, DH), generator=g, device=dev)
            if pool == "int8":
                ksc = kf.abs().amax((0, 1, 3)) / 127.0
                vsc = vf.abs().amax((0, 1, 3)) / 127.0
                kp = torch.round(kf / ksc[:, None]).clamp(-127, 127).to(torch.int8)
                vp = torch.round(vf / vsc[:, None]).clamp(-127, 127).to(torch.int8)
                sc = dict(k_scale=ksc.float().contiguous(),
                          v_scale=vsc.float().contiguous())
            else:
                kp, vp, sc = kf.to(qdt), vf.to(qdt), {}
            elem = kp.element_size()
            # shuffled pages; entries past each sequence's last page are
            # stale ids of other pages, which must stay masked
            pt = (torch.randperm(P - 1, generator=g, device=dev)[:B * n_pp]
                  .reshape(B, n_pp) + 1).to(torch.int32)
            lens = torch.randint(1, MAX_LEN + 1, (B,), generator=g,
                                 device=dev).to(torch.int32)
            lens[0], lens[1] = MAX_LEN, 1
            kd = kern._dequant(kp, pt, sc.get("k_scale")).to(qdt)
            vd = kern._dequant(vp, pt, sc.get("v_scale")).to(qdt)
            grp = H // Hkv
            kdh = kd.permute(0, 2, 1, 3).repeat_interleave(grp, 1)
            vdh = vd.permute(0, 2, 1, 3).repeat_interleave(grp, 1)
            tol = 1e-4 if pool == "float32" else 2e-2
            kv_row = 2 * Hkv * DH * elem + (8 * Hkv if sc else 0)

            # decode: q (B, H, dh) at the seq_lens above
            q = torch.randn((B, H, DH), generator=g, device=dev).to(qdt)
            pos = torch.arange(n_pp * PS, device=dev)
            dmask = (pos[None] < lens[:, None])[:, None, None]
            n_keys = int(lens.sum())
            yield ("paged_decode_attention", f"group={grp} pool={pool}",
                   pool if pool != "int8" else "bfloat16",
                   lambda q=q, kp=kp, vp=vp, pt=pt, lens=lens, sc=sc:
                       kern.paged_decode_attention(q, kp, vp, pt, lens, **sc),
                   lambda q=q, kp=kp, vp=vp, pt=pt, lens=lens, sc=sc:
                       kern.paged_decode_attention_plain(q, kp, vp, pt, lens,
                                                         **sc),
                   lambda q=q, k=kdh, v=vdh, m=dmask:
                       F.scaled_dot_product_attention(q[:, :, None], k, v,
                                                      attn_mask=m),
                   2 * q.numel() * q.element_size() + pt.numel() * 4
                   + B * 4 + n_keys * kv_row,
                   4 * H * DH * n_keys, tol)

            # chunk: scalar start (B=1, as the engine prefills) and a
            # per-sequence start (B=4)
            for label, starts, reals in (
                    ("start=scalar", [384], [64]),
                    ("start=(B,)", [0, 64, 320, 512], [64, 37, 64, 50])):
                Bc = len(starts)
                qc = torch.randn((Bc, C, H, DH), generator=g,
                                 device=dev).to(qdt)
                st = torch.tensor(starts, dtype=torch.int32, device=dev)
                nv = st + torch.tensor(reals, dtype=torch.int32, device=dev)
                s_arg = starts[0] if Bc == 1 else st
                ptc = pt[:Bc].contiguous()
                qpos = st[:, None] + torch.arange(C, device=dev)
                lim = torch.minimum(qpos + 1, nv[:, None])        # (Bc, C)
                cmask = (pos[None, None] < lim[..., None])[:, None]
                keys = int(torch.minimum(st + C, nv).sum())
                row_keys = int(lim.sum())
                yield ("chunk_prefill_attention",
                       f"group={grp} pool={pool} {label}",
                       pool if pool != "int8" else "bfloat16",
                       lambda q=qc, kp=kp, vp=vp, pt=ptc, s=s_arg, nv=nv,
                       sc=sc: kern.chunk_prefill_attention(q, kp, vp, pt, s,
                                                           nv, **sc),
                       lambda q=qc, kp=kp, vp=vp, pt=ptc, s=s_arg, nv=nv,
                       sc=sc: kern.chunk_prefill_attention_plain(
                           q, kp, vp, pt, s, nv, **sc),
                       lambda q=qc, k=kdh[:Bc], v=vdh[:Bc], m=cmask:
                           F.scaled_dot_product_attention(
                               q.transpose(1, 2), k, v, attn_mask=m),
                       2 * qc.numel() * qc.element_size() + ptc.numel() * 4
                       + 8 * Bc + keys * kv_row,
                       4 * H * DH * row_keys, tol)


def check_kernels(torch, kern):
    rows = []
    for (name, label, ops_type, fn, plain, sdpa, nbytes, ops,
         tol) in kernel_cases(torch, kern):
        got = fn()
        want = plain()
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        check(math.isfinite(err) and err <= tol,
              f"{name} [{label}] max_abs_err {err:.3g} > {tol:g}")
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / PEAK_OPS[ops_type] * 1e3
        row = dict(name=name, case=label, max_abs_err=err, tol=tol,
                   ms=median_ms(torch, fn), plain_ms=median_ms(torch, plain),
                   library_ms=median_ms(torch, sdpa),
                   bound_ms=max(bytes_ms, ops_ms),
                   bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                   bytes=nbytes, ops=ops)
        rows.append(row)
        log(f"{name:24s} {label:38s} err={err:.2e} (tol {tol:g}) "
            f"kernel={row['ms']:.4f}ms plain={row['plain_ms']:.4f}ms "
            f"sdpa={row['library_ms']:.4f}ms bound={row['bound_ms']:.4f}ms "
            f"({row['bound_by']})")
    return rows


# ------------------------------ phase 4 --------------------------------- #

def requests(vocab: int):
    """16 prompts of 64-448 tokens from a fixed seed; 8 of them open with
    one shared 128-token document."""
    import numpy as np
    rng = np.random.default_rng(0)
    doc = rng.integers(1, vocab, size=128).tolist()
    reqs = []
    for i in range(16):
        if i % 2 == 0:
            n = int(rng.integers(160, 449))
            reqs.append(doc + rng.integers(1, vocab, size=n - 128).tolist())
        else:
            n = int(rng.integers(64, 449))
            reqs.append(rng.integers(1, vocab, size=n).tolist())
    return reqs


def serve_full_width(torch, kern, ServeEngine, RuntimeOptions, cfg):
    reqs = requests(cfg.vocab)
    results = {}
    params = None
    kern.paged_decode_attention.launches = 0
    kern.chunk_prefill_attention.launches = 0
    for policy in ("native", "int8"):
        before = (kern.paged_decode_attention.launches,
                  kern.chunk_prefill_attention.launches)
        t0 = time.perf_counter()
        eng = ServeEngine(cfg, params, RuntimeOptions(dtype="bfloat16"),
                          device="cuda", seed=0, kv_policy=policy,
                          scheduler="continuous", page_size=PS, max_batch=8,
                          prefill_chunk=C, decode_lookahead=8,
                          max_len=MAX_LEN)
        params = eng.params                 # one seeded init for both runs
        outs = eng.serve([r[:] for r in reqs], 64)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        s = eng.stats
        n_dec = kern.paged_decode_attention.launches - before[0]
        n_chk = kern.chunk_prefill_attention.launches - before[1]
        check(n_dec > 0 and n_chk > 0, f"{policy}: kernels not launched")
        check(eng.trace_report["ok"], f"{policy}: trace did not reconcile")
        check(eng.kv_manager.n_used == 0, f"{policy}: pages leaked")
        check(all(len(o) == 64 and all(0 <= t < cfg.vocab for t in o)
                  for o in outs), f"{policy}: malformed outputs")
        saved = s.cached_prefix_tokens
        results[policy] = dict(
            tokens_per_s=s.tps, ttft_p50_ms=s.ttft_p50 * 1e3,
            ttft_p95_ms=s.ttft_p95 * 1e3, itl_p50_ms=s.itl_p50 * 1e3,
            itl_p95_ms=s.itl_p95 * 1e3, host_syncs=s.host_syncs,
            prefill_tokens_computed=s.prefill_tokens_computed,
            prefill_tokens_saved=saved, peak_pages=s.peak_pages_used,
            cow_copies=s.cow_copies, decode_steps=s.decode_steps,
            prefill_s=s.prefill_s, decode_s=s.decode_s, serve_s=s.serve_s,
            wall_s=wall, decode_launches=n_dec, chunk_launches=n_chk)
        log(f"engine {policy:6s} tokens/s={s.tps:.1f} "
            f"ttft p50/p95={s.ttft_p50*1e3:.1f}/{s.ttft_p95*1e3:.1f}ms "
            f"itl p50/p95={s.itl_p50*1e3:.2f}/{s.itl_p95*1e3:.2f}ms "
            f"host_syncs={s.host_syncs} prefill_saved={saved} "
            f"peak_pages={s.peak_pages_used} launches decode={n_dec} "
            f"chunk={n_chk} wall={wall:.1f}s")
    launches = {"paged_decode_attention": kern.paged_decode_attention.launches,
                "chunk_prefill_attention":
                    kern.chunk_prefill_attention.launches}
    return results, launches, params


def profile_decode_block(torch, tm, cfg, params):
    """Where a fused decode block's time goes: one K=8 block over 8 slots
    holding 300 cached tokens each, at full width. Device busy time is the
    sum of the kernels torch.profiler records; the wall time is taken
    without the profiler (median of 5)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    opts = tm.RuntimeOptions(dtype="bfloat16")
    B, K = 8, 8
    n_pp = -(-MAX_LEN // PS)
    cache = tm.init_paged_cache(cfg, B * n_pp + 1, PS, opts, "cuda")
    pt = torch.arange(1, B * n_pp + 1, dtype=torch.int32,
                      device="cuda").reshape(B, n_pp)
    lens = torch.full((B,), 300, dtype=torch.int32, device="cuda")
    tok = torch.arange(1, B + 1, dtype=torch.int32, device="cuda")

    def block():
        tm.decode_steps_paged(cfg, params, tok, lens, pt, cache, K, opts)
        torch.cuda.synchronize()
    block()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        block()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = statistics.median(walls)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        block()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
    busy_ms = sum(by_name.values())
    check(busy_ms > 0, "the profiler recorded no device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    attn = sum(v for k, v in by_name.items() if "repro_paged" in k)
    log(f"decode block K={K} B={B} len=300: wall {wall_ms:.2f}ms, device "
        f"busy {busy_ms:.2f}ms ({100 * busy_ms / wall_ms:.1f}% of wall), "
        f"paged attention {attn:.2f}ms "
        f"({100 * attn / busy_ms:.1f}% of busy)")
    for name, ms in top:
        log(f"  {ms:7.3f}ms {100 * ms / busy_ms:5.1f}%  {name[:70]}")
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                busy_share=busy_ms / wall_ms, attention_ms=attn,
                top=[dict(name=n, ms=v) for n, v in top])


# ------------------------------ phase 5 --------------------------------- #

def f32_checks(torch, tm, ServeEngine, cfg):
    import numpy as np
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = tm.init_params(cfg, gen, "float32", "cuda")
    opts = tm.RuntimeOptions(dtype="float32")

    # the kernel path against the CPU plain path, one prompt
    rng = np.random.default_rng(1)
    toks = rng.integers(1, cfg.vocab, size=(1, C)).astype(np.int32)
    n_pp = -(-MAX_LEN // PS)
    pt = np.zeros((1, n_pp), np.int32)
    pt[0, :6] = [7, 3, 11, 5, 9, 2]
    logits = {}
    for dev in ("cuda", "cpu"):
        p = params if dev == "cuda" else _to(params, "cpu")
        cache = tm.init_paged_cache(cfg, 13, PS, opts, dev)
        lg, cache = tm.prefill_paged_chunk(
            cfg, p, torch.as_tensor(toks, device=dev), cache,
            torch.as_tensor(pt, device=dev), 0,
            torch.tensor([C - 3], dtype=torch.int32, device=dev), opts)
        tok = torch.tensor([int(toks[0, 5])], dtype=torch.int32, device=dev)
        ld, _ = tm.decode_step_paged(
            cfg, p, tok, torch.tensor([C - 3], dtype=torch.int32, device=dev),
            torch.as_tensor(pt, device=dev), cache, opts)
        logits[dev] = (lg[0, :C - 3].float().cpu(), ld.float().cpu())
    err = max(float((a - b).abs().max())
              for a, b in zip(logits["cuda"], logits["cpu"]))
    scale = float(logits["cpu"][0].abs().max())
    log(f"f32 kernel path vs CPU plain path: max |logit diff| = {err:.2e} "
        f"(max |logit| {scale:.2f})")
    check(err <= 2e-3 * max(scale, 1.0), "GPU and CPU logits disagree")

    # decode_lookahead 8 == decode_lookahead 1
    reqs = [rng.integers(1, cfg.vocab, size=int(n)).tolist()
            for n in rng.integers(16, 129, size=4)]
    outs = {}
    for k in (1, 8):
        eng = ServeEngine(cfg, params, opts, device="cuda",
                          scheduler="continuous", page_size=PS, max_batch=8,
                          prefill_chunk=C, decode_lookahead=k,
                          max_len=MAX_LEN)
        outs[k] = eng.serve([r[:] for r in reqs], 16)
        check(eng.trace_report["ok"] and eng.kv_manager.n_used == 0,
              f"K={k}: trace did not reconcile or pages leaked")
    check(outs[1] == outs[8], "decode_lookahead 8 diverged from 1")
    log(f"f32 decode_lookahead 8 == 1 on {len(reqs)} requests "
        f"({sum(map(len, outs[8]))} tokens)")
    return err


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


# -------------------------------- main ---------------------------------- #

def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("[smoke] FAIL: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print("[smoke] FAIL: run from the root of a checkout (src/repro_torch "
              "is missing)", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, str(src))
    t_start = time.perf_counter()

    # ---- phase 1 ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # ---- phase 2 ----
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as kern
    import repro_torch.models as tm
    from repro_torch.serving import ServeEngine
    t0 = time.perf_counter()
    built = kern.build_kernels()
    log(f"build {time.perf_counter() - t0:.1f}s "
        + " ".join(f"{k}={v:.1f}s" for k, v in built.items()))
    for name in kern._SOURCES:
        text = kern.build_log(name)
        regs = [int(n) for n in re.findall(r"Used (\d+) registers", text)]
        spills = [int(n) for n in re.findall(r"(\d+) bytes spill stores",
                                             text)]
        smem = [int(n) for n in re.findall(r"(\d+) bytes smem", text)]
        log(f"ptxas {name}: {len(regs)} kernels, registers "
            f"{min(regs, default=0)}-{max(regs, default=0)}, smem max "
            f"{max(smem, default=0)} B, spill stores max "
            f"{max(spills, default=0)} B")

    # ---- phase 3 ----
    rows = check_kernels(torch, kern)

    # ---- phase 4 ----
    cfg = get_config("llama3.2-1b")
    engine, launches, params = serve_full_width(torch, kern, ServeEngine,
                                                tm.RuntimeOptions, cfg)
    breakdown = profile_decode_block(torch, tm, cfg, params)
    del params
    torch.cuda.empty_cache()

    # ---- phase 5 ----
    f32_err = f32_checks(torch, tm, ServeEngine, cfg)

    # the main path's configuration: bf16 pool, group 1 (llama3.2-1b as
    # the paper sizes it: 32 KV heads), and the engine's scalar-start chunk
    head = {"paged_decode_attention": "group=1 pool=bfloat16",
            "chunk_prefill_attention":
                "group=1 pool=bfloat16 start=scalar"}
    replaces = {"paged_decode_attention":
                    "src/repro/kernels/decode_attention.py:180",
                "chunk_prefill_attention":
                    "src/repro/kernels/decode_attention.py:284"}
    kernels = []
    for name, case in head.items():
        r = next(r for r in rows if r["name"] == name and r["case"] == case)
        kernels.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{kern._SOURCES[name]}",
            replaces=replaces[name], launches=launches[name],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"]))
    log(f"total {time.perf_counter() - t_start:.1f}s")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(
            gpu=smi, kernel_cases=rows, engine=engine,
            decode_block=breakdown, f32_logit_err=f32_err,
            build_s=built, kernels=kernels), indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
