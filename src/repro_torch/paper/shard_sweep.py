"""Multi-device sharded serving sweep (the reference's
``benchmarks/shard_sweep.py`` on the port; DESIGN.md SS16).

Three questions, answered with the port's head-sharded engine
(``ServeEngine(shards=N)``: N ranks of one ``torch.distributed`` process
group, each holding Hkv/N KV heads of every page):

* **overlap** — does the two-stream engine (prefill worker + decode
  worker on the virtual clock) beat the serialized loop on a mixed
  prefill+decode workload? Gate: overlapped TPS > serialized TPS, token
  identity across both.
* **mesh** — token identity of the head-sharded engine across shard
  counts {1, 2, 4}, plus per-mesh makespan/TPS, and the per-device
  analytic bridge: ``concurrent_inference(kv_shards=N)`` at full 13B
  scale shows the per-chip KV footprint shrinking with N (the paper's
  memory constraint is per chip).
* **capacity** — a per-device tier budget admits what one device cannot:
  a working set the single-device pool rejects outright serves
  token-identically on four shards, and a concurrent workload that
  forces preemptions at N=1 runs preemption-free at N=4.

The reference runs its meshes on host devices of one process. Here a
shard count is a group of that many ranks (``run_groups``, through
``launch.ranks.run_ranks``): one group of 2 serves the mesh cell at N=2,
one group of 4 the mesh cell and both capacity cells at N=4 (on the card
one group after the other, on the CPU side by side), and the cells at
N=1 run in the calling process. Ranks on the card share it
over gloo, or take a card each over nccl where there are enough
(``launch.ranks.backend_for``). A rank draws the engine's seeded init
unless it is handed weights, so its weights are those of the calling
process's engines.

On the CPU the engines serve the reference's reduced twin (f32, d_model
64, 2 layers, 4 KV heads); on the card llama3.2-1b at full width (32 KV
heads, which 1, 2 and 4 divide) in bf16, cut to ``CARD_LAYERS`` layers,
since the twin's head width 16 is one no kernel takes
(``models.kernel_width_reason``). The capacity section's tiers are sized
in pages of the pool's own element width, so the card's cells hold the
twin's page counts. Each engine serves the requests twice and reports
the second serve, as the reference does to warm its jit.

Run: PYTHONPATH=src python -m repro_torch.paper.shard_sweep
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

# llama3.2-1b's layers the card serves (of 16), for time
CARD_LAYERS = 4
# a rank group's collectives and whole run, in seconds
RANK_TIMEOUT_S = 300.0
# the cells each rank group serves: its mesh cell, and at four shards the
# capacity section's long request and concurrent mix
GROUP_CELLS = {2: ("mesh",), 4: ("mesh", "capacity_long", "capacity_conc")}


def twin_config(args):
    """The reference's reduced dense twin: 4 KV heads, divisible by 1, 2
    and 4."""
    return dataclasses.replace(
        reduced(get_config("llama3.2-1b"), d_model=args.d_model,
                n_layers=2, vocab=128),
        n_kv_heads=4)


def measured_model(args):
    """(config, options) the sweep serves on ``args.device``: the twin in
    f32 on the CPU; on the card llama3.2-1b at full width (d_model 2,048,
    32 heads of 64 over 32 KV heads), bf16, ``CARD_LAYERS`` of its 16
    layers."""
    from repro_torch.models import RuntimeOptions
    if torch.device(args.device).type == "cuda":
        cfg = dataclasses.replace(get_config("llama3.2-1b"),
                                  n_layers=CARD_LAYERS,
                                  name=f"llama3.2-1b-{CARD_LAYERS}L")
        return cfg, RuntimeOptions(dtype="bfloat16")
    return twin_config(args), RuntimeOptions(dtype="float32")


def _workload(cfg, args):
    """Mixed prefill+decode stream: ragged prompts, more requests than
    slots, so admissions keep prefilling while earlier requests decode —
    the regime where the two streams actually overlap."""
    rng = np.random.default_rng(0)
    lens = [args.prompt_len if i % 2 == 0 else max(args.prompt_len // 3, 4)
            for i in range(args.n_requests)]
    return [rng.integers(1, cfg.vocab, size=n).tolist() for n in lens]


def _run(cfg, params, opts, reqs, args, **kw):
    """An engine of ``kw`` over the sweep's settings, warmed by one serve;
    returns it and its second serve's outputs."""
    from repro_torch.serving import ServeEngine

    common = dict(device=args.device, seed=0,
                  max_len=args.prompt_len + args.new_tokens,
                  scheduler="continuous", page_size=args.page_size,
                  max_batch=args.max_batch)
    common.update(kw)
    eng = ServeEngine(cfg, params, opts, **common)
    eng.serve([r[:] for r in reqs], args.new_tokens)       # warm
    eng.stats.__init__()
    outs = eng.serve([r[:] for r in reqs], args.new_tokens)
    return eng, outs


def _cell(eng):
    s = eng.stats
    return {"tps": round(s.tps, 2),
            "serve_ms": round(s.serve_s * 1e3, 3),
            "prefill_ms": round(s.prefill_s * 1e3, 3),
            "decode_ms": round(s.decode_s * 1e3, 3),
            "preemptions": s.preemptions,
            "peak_fast_pages": s.peak_fast_pages,
            # beside the reference's fields: the counters the schedule
            # fixes when the streams are serialized, the trace's
            # reconcile, the freed pages, and the bytes of the pool this
            # device holds (the engine's pages at its shard's heads)
            "counters": {"decode_steps": s.decode_steps,
                         "host_syncs": s.host_syncs,
                         "preemptions": s.preemptions,
                         "peak_fast_pages": s.peak_fast_pages,
                         "peak_pages_used": s.peak_pages_used},
            "trace_reconciled": eng.trace_report["ok"],
            "pages_left": eng.kv_manager.n_used,
            "pool_bytes": int(eng.kv_manager.n_pages
                              * eng.page_nbytes_shard)}


def _setup(args, params):
    """(config, options, params on the device or None)."""
    cfg, opts = measured_model(args)
    if params is not None:
        from repro_torch.tree import tree_map
        params = tree_map(lambda t: t.to(args.device), params)
    return cfg, opts, params


def _page_nbytes(cfg, opts, args) -> int:
    from repro_torch.models import torch_dtype
    from repro_torch.serving.kv_manager import page_bytes
    # the pool's own element width: a bf16 tier holds twice the f32 pages
    return page_bytes(cfg, args.page_size, torch_dtype(opts.dtype).itemsize)


def _capacity_inputs(cfg, opts, args):
    """The capacity section's requests and tiers: (a) one long request
    (4 pages + new) and a hierarchy of 1.5 fast and 2.5 HBS pages, which
    holds it only in 1/4 pages; (b) four requests whose joint working set
    exceeds a hierarchy of ``need // 4 + 0.5`` fast and ``need // 2 - need
    // 4 + 0.5`` HBS pages, while each fits alone."""
    from repro_torch.core import hbs, lpddr6, npu_hierarchy
    ps = args.page_size
    pb = _page_nbytes(cfg, opts, args)
    rng = np.random.default_rng(7)
    long_req = rng.integers(1, cfg.vocab,
                            size=3 * ps).tolist()          # 4 pages + new
    tight = npu_hierarchy(lpddr6(capacity_gb=1.5 * pb / 1e9),
                          hbs(1e3, latency_us=0.0,
                              capacity_gb=2.5 * pb / 1e9))
    conc = [rng.integers(1, cfg.vocab, size=2 * ps).tolist()
            for _ in range(4)]
    need = sum(-(-(len(r) + args.new_tokens) // ps) for r in conc)
    tight2 = npu_hierarchy(
        lpddr6(capacity_gb=(need // 4 + 0.5) * pb / 1e9),
        hbs(1e3, latency_us=0.0,
            capacity_gb=(need // 2 - need // 4 + 0.5) * pb / 1e9))
    return long_req, tight, conc, tight2


def _serve_cell(cfg, params, opts, args, name, shards, overlap):
    """One cell of ``GROUP_CELLS`` (or its N=1 counterpart) at ``shards``:
    (engine, outputs)."""
    if name == "mesh":
        return _run(cfg, params, opts, _workload(cfg, args), args,
                    shards=shards, overlap=overlap)
    long_req, tight, conc, tight2 = _capacity_inputs(cfg, opts, args)
    if name == "capacity_long":
        return _run(cfg, params, opts, [long_req], args, hierarchy=tight,
                    shards=shards, overlap=overlap)
    return _run(cfg, params, opts, conc, args, hierarchy=tight2,
                max_batch=4, shards=shards, overlap=overlap)


def rank_cells(rank, args, shards, names, params, overlap):
    """One rank of a group of ``shards`` (spawned by ``run_groups``): the
    cells ``names`` on this rank's head slice. Returns {name: {"cell",
    "outs", "device", "backend"}}."""
    import torch.distributed as dist
    cfg, opts, params = _setup(args, params)
    out = {}
    for name in names:
        eng, outs = _serve_cell(cfg, params, opts, args, name, shards,
                                overlap)
        params = eng.params                  # one init for every engine
        out[name] = dict(cell=_cell(eng), outs=outs, device=str(eng.device),
                         backend=dist.get_backend())
    return out


def run_groups(args, params=None, overlap: bool = True,
               cells=None) -> dict:
    """Each shard count's rank group of ``cells`` ({shards: cell names};
    default ``GROUP_CELLS``): {shards: [each rank's ``rank_cells``]}.
    On the card the groups run one after another, so that each group's
    serves are timed alone; on the CPU, where every rank is a process of
    the host either way, side by side. ``params``: the weights, sent to
    the ranks as CPU tensors (default: each rank draws the engine's
    seeded init)."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.launch.ranks import backend_for, run_ranks
    from repro_torch.tree import tree_map
    if params is not None:
        params = tree_map(lambda t: t.detach().cpu(), params)
    groups = GROUP_CELLS if cells is None else cells

    def run(n):
        return run_ranks(rank_cells, n, (args, n, groups[n], params, overlap),
                         backend=backend_for(n, args.device),
                         timeout=RANK_TIMEOUT_S)
    if torch.device(args.device).type == "cuda":
        return {n: run(n) for n in groups}
    with ThreadPoolExecutor(len(groups)) as pool:
        return dict(zip(groups, pool.map(run, groups)))


def _group_cell(groups, n, name, want):
    """Rank 0's cell of ``name`` in group ``n``, token-identical when every
    rank's outputs equal ``want``."""
    ranks = groups[n]
    return dict(ranks[0][name]["cell"],
                token_identical=all(r[name]["outs"] == want for r in ranks))


def overlap_section(args, params=None, overlap: bool = True,
                    want=None) -> dict:
    """Overlapped against serialized streams at one shard. ``want``: the
    outputs both are held to (default: a serve at ``overlap``, the
    reference's plain single-device engine); ``params``: the weights
    (default: the engine's seeded init)."""
    cfg, opts, params = _setup(args, params)
    reqs = _workload(cfg, args)
    over, o_outs = _run(cfg, params, opts, reqs, args, overlap=True)
    params = over.params
    ser, s_outs = _run(cfg, params, opts, reqs, args, overlap=False)
    if want is None:
        want = o_outs if overlap else s_outs
    o, s = _cell(over), _cell(ser)
    return {
        "overlapped": o, "serialized": s,
        "token_identical": o_outs == want and s_outs == want,
        "speedup": round(s["serve_ms"] / max(o["serve_ms"], 1e-9), 3),
        "overlap_beats_serialized": o["tps"] > s["tps"],
    }


def analytic_bridge() -> dict:
    """The per-device analytic bridge at FULL 13B scale: each chip holds
    1/N of the paged KV, so the per-chip footprint (the paper's
    constraint) shrinks with the mesh while weights/activations
    replicate. CPU arithmetic."""
    from repro_torch.core import (TC, concurrent_inference, ddr_only, hbs,
                                  lpddr6, npu_hierarchy, resident_bytes)
    big = get_config("llava15-13b")
    hier = npu_hierarchy(lpddr6(520.0, capacity_gb=32.0),
                         hbs(8.0, latency_us=20.0, capacity_gb=64.0))
    analytic = {}
    for n in (1, 2, 4):
        pt = concurrent_inference(big, hier, ddr_only(), n_concurrent=4,
                                  prefill_len=4096, decode_len=256,
                                  dtype_bytes=2, kv_shards=n)
        fp = resident_bytes(big, 4096 + 256, 4, 2)
        analytic[f"kv_shards{n}"] = {
            "kv_gb_per_chip": round(fp[TC.KV] / n / 1e9, 3),
            "aggregate_tps": round(pt.aggregate_tps, 3),
        }
    return analytic


def mesh_section(args, params=None, overlap: bool = True, want=None,
                 groups=None, shard_counts=(1, 2, 4)) -> dict:
    """The mesh cell at each of ``shard_counts`` that divides the KV
    heads, held to ``want`` (default: the N=1 cell's outputs) on every
    rank; ``groups``: ``run_groups``' results for the counts above 1
    (default: spawned here); ``params`` and ``overlap`` as in
    ``overlap_section``."""
    cfg, opts, params = _setup(args, params)
    counts = [n for n in shard_counts if not cfg.n_kv_heads % n]
    cells = {}
    if 1 in counts:
        eng, outs = _serve_cell(cfg, params, opts, args, "mesh", 1, overlap)
        want = outs if want is None else want
        cells["mesh1"] = dict(_cell(eng), token_identical=outs == want)
    multi = [n for n in counts if n > 1]
    if multi and groups is None:
        groups = run_groups(args, params, overlap,
                            {n: ("mesh",) for n in multi})
    for n in multi:
        cells[f"mesh{n}"] = _group_cell(groups, n, "mesh", want)
    analytic = analytic_bridge()
    kv1 = analytic["kv_shards1"]["kv_gb_per_chip"]
    kv4 = analytic["kv_shards4"]["kv_gb_per_chip"]
    return {"shard_counts": counts, "cells": cells,
            "all_token_identical": all(c["token_identical"]
                                       for c in cells.values()),
            "analytic_13b_per_chip": analytic,
            "per_chip_kv_shrinks": kv4 < kv1}


def capacity_section(args, params=None, overlap: bool = True, groups=None,
                     shard_counts=(1, 4)) -> dict:
    """The per-device tier budget: the single device against four shards
    (where 4 is in ``shard_counts``; ``groups`` as in ``mesh_section``),
    each held to a plain single-device serve of the same requests;
    ``params`` and ``overlap`` as in ``overlap_section``."""
    cfg, opts, params = _setup(args, params)
    long_req, tight, conc, tight2 = _capacity_inputs(cfg, opts, args)
    mesh4 = 4 in shard_counts

    def want_fn(rs):
        eng, outs = _run(cfg, params, opts, rs, args, overlap=overlap)
        return eng.params, outs

    # (a) reject vs serve: one long request whose KV exceeds the WHOLE
    # single-device hierarchy but fits the 4-way per-device slices
    single_rejects = False
    try:
        _run(cfg, params, opts, [long_req], args, hierarchy=tight,
             overlap=overlap)
    except ValueError as e:
        single_rejects = "across all" in str(e)
    out = {"single_device_rejects": single_rejects}
    if mesh4 and groups is None:
        groups = run_groups(args, params, overlap,
                            {4: ("capacity_long", "capacity_conc")})
    if mesh4:
        params, want = want_fn([long_req])
        c = _group_cell(groups, 4, "capacity_long", want)
        out["mesh4_serves_token_identical"] = c["token_identical"]
        out["mesh4_peak_fast_pages"] = c["peak_fast_pages"]

    # (b) concurrency under pressure: each request fits alone, but the
    # JOINT working set exceeds the N=1 pool — the scheduler can only run
    # the mix by preempting. The 4-way per-device budget holds 4x the
    # pages, so the same mix runs fully resident, preemption-free.
    params, want = want_fn(conc)
    eng1, outs1 = _serve_cell(cfg, params, opts, args, "capacity_conc", 1,
                              overlap)
    out["n1"] = dict(_cell(eng1), token_identical=outs1 == want)
    if mesh4:
        out["n4"] = _group_cell(groups, 4, "capacity_conc", want)
        out["mesh_relieves_pressure"] = (
            out["n1"]["preemptions"] > 0 and out["n4"]["preemptions"] == 0)
    return out


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where the engines and ranks serve (default cuda)")
    ap.add_argument("--out", default=None,
                    help="also write the printed JSON to this file")
    ap.add_argument("--d-model", type=int, default=64,
                    help="the CPU twin's width (the card serves "
                         "llama3.2-1b's own)")
    ap.add_argument("--n-requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=3)
    return ap


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    from repro_torch.models import init_params, resolve_device
    resolve_device(args.device)
    cfg, opts, _ = _setup(args, None)
    reqs = _workload(cfg, args)
    # one seeded init for every engine here, as the engine itself draws it
    # and as each rank draws it
    gen = torch.Generator(device=args.device).manual_seed(0)
    params = init_params(cfg, gen, opts.dtype, args.device)
    groups = run_groups(args)

    # token-identity reference: the plain single-device overlapped engine
    _, want = _run(cfg, params, opts, reqs, args)
    results = {
        "workload": {
            "arch": cfg.name, "device": str(args.device),
            "dtype": opts.dtype, "n_layers": cfg.n_layers,
            "n_requests": len(reqs),
            "prompt_lens": sorted({len(r) for r in reqs}),
            "new_tokens": args.new_tokens,
            "max_batch": args.max_batch, "page_size": args.page_size,
        },
        "overlap": overlap_section(args, params, want=want),
        "mesh": mesh_section(args, params, want=want, groups=groups),
        "capacity": capacity_section(args, params, groups=groups),
    }
    text = json.dumps(results, indent=2)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    gates = (results["overlap"]["overlap_beats_serialized"],
             results["overlap"]["token_identical"],
             results["mesh"]["all_token_identical"],
             results["capacity"]["single_device_rejects"])
    print(f"[shard_sweep] gates: overlap_beats_serialized={gates[0]} "
          f"token_identical={gates[1]} mesh_identical={gates[2]} "
          f"per_device_budget={gates[3]}")
    return results


if __name__ == "__main__":
    main()
