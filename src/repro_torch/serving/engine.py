"""Continuous-batching serve engine over the paged, tiered KV pool, in
PyTorch (the reference is ``repro/serving/engine.py``).

``ServeEngine(scheduler="continuous")`` is the only engine this slice
ports: iteration-level batching over a pool of fixed-size KV pages (native
or int8), shared-prefix page reuse with copy-on-write, chunked prefill, and
a fused K-step greedy decode block with one host sync per block. Page
residency across a ``MemoryHierarchy`` (HBS offload, chiplet promotion)
is charged on a virtual clock exactly as in the reference. On the card
every prefill chunk and decode step attends through the hand-written
kernels of ``kernels.decode_attention``.

CUDA work is asynchronous, so each timed bracket closes after the host
pull (or a ``torch.cuda.synchronize()``) that ends it: ``prefill_s``,
``decode_s`` and the virtual clock measure kernel time, not launch time.

Not ported yet, and rejected with ``NotImplementedError``: the static
engine (ROADMAP.md A6), speculative decoding and stochastic sampling (A5),
head-sharded serving (A9), and families other than dense GQA/MHA (A7,
A10).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import (RuntimeOptions, copy_pages,
                                decode_steps_paged, init_paged_cache,
                                init_params, layer_dma_slices,
                                paged_supported, prefill_paged_chunk,
                                resolve_device, torch_dtype)
from repro_torch.serving import metrics
from repro_torch.serving.kv_manager import (PagedKVManager,
                                            SimulatedTierDevice, TierBudget,
                                            page_bytes)
from repro_torch.serving.scheduler import (PREFILLING, RUNNING,
                                           ContinuousScheduler, Request)
from repro_torch.serving.streams import VirtualStream
from repro_torch.serving.trace import DECODE, STALL, TraceRecorder


def _next_pow2(n: int) -> int:
    """Smallest power of two >= max(n, 1)."""
    p = 1
    while p < n:
        p *= 2
    return p


def _pad_pow2(items: List, pad_item) -> List:
    """Pad a work list to the next power-of-two length with inert filler,
    so the COW copy batches take O(log n) distinct shapes (as in the
    reference, where each shape is one compile)."""
    return list(items) + [pad_item] * (_next_pow2(len(items)) - len(items))


def _sync(device: torch.device) -> None:
    """Wait for the device's queued work (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class ServeStats:
    prefill_s: float = 0.0
    decode_s: float = 0.0
    # serve makespan on the virtual stream clock: max over the
    # prefill/decode streams' horizons, summed across serve() calls. With
    # overlap it is LESS than prefill_s + decode_s — that gap is the
    # overlapped time, and what tps prices.
    serve_s: float = 0.0
    new_tokens: int = 0
    requests: int = 0
    decode_steps: int = 0
    preemptions: int = 0
    # chunked prefill + prefix sharing observability (continuous scheduler)
    prefill_tokens_computed: int = 0    # chunk tokens actually run
    cached_prefix_tokens: int = 0       # prompt tokens served from the cache
    pages_deduped: int = 0              # page allocations avoided by sharing
    cow_copies: int = 0
    peak_pages_used: int = 0            # max distinct in-use pages
    prefill_compiles: int = 0           # distinct prefill shapes seen
    # fused multi-step decode observability
    host_syncs: int = 0                 # device->host round-trips taken
    decode_compiles: int = 0            # distinct decode shapes seen
    # HBS page offload: migration traffic + decode stalls charged in
    # virtual seconds by the SimulatedTierDevice
    stall_s: float = 0.0                # kernel launches waiting on fetches
    spill_bytes: float = 0.0            # dirty write-back traffic (out)
    fetch_bytes: float = 0.0            # offload -> fast migration traffic
    pages_spilled: int = 0
    pages_fetched: int = 0
    peak_fast_pages: int = 0            # max fast-tier (non-offload) pages
    prefetch_hits: int = 0              # fetches that beat their kernel
    prefetch_misses: int = 0            # fetches a kernel had to wait on
    # per-direction DMA bytes keyed "src->dst" at each link boundary
    channel_bytes: Dict[str, float] = field(default_factory=dict)
    clean_demotions: int = 0            # spills that skipped write-back
    # chiplet promotion level
    chiplet_promotions: int = 0
    chiplet_demotions: int = 0
    tier_touches: Dict[str, int] = field(default_factory=dict)
    # stall the layer-sliced overlap hid vs the whole-block barrier
    # counterfactual (0 when layer_overlap is off)
    stall_saved_s: float = 0.0
    # runtime -> analytic bridge: the landed-page tier split observed at
    # peak occupancy
    kv_split_at_peak: tuple = ()
    # speculative decoding (not ported yet: always 0 here)
    draft_proposed: int = 0
    draft_accepted: int = 0
    spec_blocks: int = 0
    # per-request attribution of residency stall
    stall_by_rid: Dict[int, float] = field(default_factory=dict)
    # per-request latency samples (seconds)
    ttft: List[float] = field(default_factory=list)
    itl: List[float] = field(default_factory=list)

    @property
    def prefetch_hit_rate(self) -> float:
        n = self.prefetch_hits + self.prefetch_misses
        return self.prefetch_hits / n if n else 1.0

    @property
    def chiplet_hit_rate(self) -> float:
        """Fraction of landed-page kernel reads served from the chiplet
        level (0.0 when no chiplet tier is configured)."""
        total = sum(self.tier_touches.values())
        return (self.tier_touches.get("chiplet", 0) / total
                if total else 0.0)

    @property
    def acceptance_rate(self) -> float:
        return (self.draft_accepted / self.draft_proposed
                if self.draft_proposed else 0.0)

    @property
    def tps(self) -> float:
        """Decode tokens/sec over the full request: tokens over the
        stream-clock makespan when one was recorded, else over summed
        phase time."""
        t = (self.serve_s if self.serve_s > 0
             else self.prefill_s + self.decode_s)
        return self.new_tokens / t if t > 0 else 0.0

    def _pct(self, xs: List[float], q: float) -> float:
        return metrics.percentile(xs, q)

    @property
    def ttft_p50(self) -> float:
        return self._pct(self.ttft, 50)

    @property
    def ttft_p95(self) -> float:
        return self._pct(self.ttft, 95)

    @property
    def itl_p50(self) -> float:
        return self._pct(self.itl, 50)

    @property
    def itl_p95(self) -> float:
        return self._pct(self.itl, 95)


class ServeEngine:
    def __init__(self, cfg: ArchConfig, params=None,
                 opts: RuntimeOptions = RuntimeOptions(dtype="float32"),
                 *, device="cuda", kv_policy: str = "native",
                 max_len: int = 512, eos_id: Optional[int] = None,
                 seed: int = 0, scheduler: str = "continuous",
                 page_size: int = 16, max_batch: int = 8,
                 n_pages: Optional[int] = None, hierarchy=None,
                 prefill_chunk: Optional[int] = None,
                 prefill_budget: Optional[int] = None,
                 prefix_cache: bool = True, decode_lookahead: int = 8,
                 offload: bool = True, hbs_gbps: Optional[float] = None,
                 hbs_latency_us: Optional[float] = None,
                 chiplet_gbps: Optional[float] = None,
                 chiplet_latency_us: Optional[float] = None,
                 layer_overlap: bool = True,
                 writeback_link: str = "dedicated",
                 spec_mode: str = "off", spec_k: int = 4, draft_cfg=None,
                 draft_params=None, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 1.0, sample_seed: int = 0,
                 shards: int = 1, overlap: bool = True):
        import dataclasses
        self.device = resolve_device(device)
        if kv_policy not in ("native", "int8"):
            raise ValueError(f"kv_policy must be 'native' or 'int8', got "
                             f"{kv_policy!r}")
        if kv_policy == "int8":
            opts = dataclasses.replace(opts, cache_dtype="int8")
        # ---- what this slice of the port does not run yet ---- #
        if scheduler == "static":
            raise NotImplementedError(
                "the static dense-cache engine is not ported yet (ROADMAP.md "
                "queue A, item 6); use scheduler='continuous'")
        if scheduler != "continuous":
            raise ValueError(f"unknown scheduler {scheduler!r}")
        if spec_mode != "off" or draft_cfg is not None:
            raise NotImplementedError(
                "speculative decoding is not ported yet (ROADMAP.md queue A, "
                "item 5)")
        if temperature != 0.0 or top_k or top_p != 1.0:
            raise NotImplementedError(
                "stochastic sampling is not ported yet (ROADMAP.md queue A, "
                "item 5); the port decodes greedily (temperature 0)")
        if shards != 1:
            raise NotImplementedError(
                "head-sharded serving is not ported yet (ROADMAP.md queue A, "
                "item 9)")
        reason = paged_supported(cfg)
        if reason:
            raise NotImplementedError(
                f"continuous scheduler needs the paged KV path: {reason}")
        self.shards = shards
        self.overlap = overlap
        self.cfg = cfg
        self.opts = opts
        self.max_len = max_len
        self.eos_id = eos_id
        self.scheduler = scheduler
        self.page_size = page_size
        self.max_batch = max_batch
        if decode_lookahead < 1:
            raise ValueError(f"decode_lookahead ({decode_lookahead}) must "
                             f"be >= 1")
        self.decode_lookahead = decode_lookahead
        if params is None:
            gen_device = "cuda" if self.device.type == "cuda" else "cpu"
            gen = torch.Generator(device=gen_device).manual_seed(seed)
            params = init_params(cfg, gen, opts.dtype, self.device)
        self.params = params
        # chunk right-padding needs no reserve headroom — positions past a
        # prompt's pages spill into the reserved null page
        self.prefill_chunk = (prefill_chunk if prefill_chunk is not None
                              else max(2 * page_size, 32))
        if self.prefill_chunk % page_size:
            raise ValueError(
                f"prefill_chunk ({self.prefill_chunk}) must be a multiple "
                f"of page_size ({page_size})")
        self.prefill_budget = prefill_budget
        self.prefix_cache = prefix_cache
        self.n_pages_per_seq = -(-max_len // page_size)
        # active KV element width (int8 -> 1), threaded through the manager
        # so occupancy/migration pricing never assumes bf16
        self.kv_dtype_bytes = torch_dtype(
            opts.cache_dtype or opts.dtype).itemsize
        self.page_nbytes = page_bytes(cfg, page_size, self.kv_dtype_bytes)
        self.page_nbytes_shard = self.page_nbytes / shards
        self.tier_budget = (None if hierarchy is None else
                            TierBudget.from_hierarchy(
                                hierarchy, cfg, page_size,
                                self.kv_dtype_bytes, shards=shards))
        # HBS offload timing: migrations between the fast KV tiers and the
        # budget's slowest tier are charged in virtual time; a fresh device
        # is built per serve() so channel horizons reset between runs
        if writeback_link not in ("dedicated", "shared"):
            raise ValueError(f"writeback_link must be 'dedicated' or "
                             f"'shared', got {writeback_link!r}")
        self.writeback_link = writeback_link
        self._tier_device_args = None
        if (offload and hierarchy is not None and self.tier_budget is not None
                and self.tier_budget.offload_tier is not None):
            self._tier_device_args = (hierarchy,
                                      self.tier_budget.offload_tier,
                                      hbs_gbps, hbs_latency_us)
        # chiplet promotion level: migrations over the bonded chiplet link
        # are charged on their own device with independent in/out queues
        self._chiplet_device_args = None
        if (hierarchy is not None and self.tier_budget is not None
                and self.tier_budget.n_promote):
            self._chiplet_device_args = (hierarchy,
                                         self.tier_budget.tiers[0][0],
                                         chiplet_gbps, chiplet_latency_us)
        # layer-sliced migration overlapped with the layer loop; off -> the
        # whole-block barrier baseline
        self.layer_overlap = layer_overlap
        self.n_layer_slices = layer_dma_slices(cfg) if layer_overlap else 1
        # requested pool size; PagedKVManager clamps it to the tier budget
        self.n_pages = (n_pages if n_pages is not None
                        else max_batch * self.n_pages_per_seq + 1)
        self._chunk_shapes: set = set()   # distinct prefill shapes seen
        self._decode_shapes: set = set()  # distinct decode shapes seen
        self.kv_manager: Optional[PagedKVManager] = None  # set per serve()
        # structured trace of the LAST serve_continuous run, plus its
        # reconcile report (trace audited against ServeStats deltas)
        self.trace: Optional[TraceRecorder] = None
        self.trace_report: Optional[dict] = None
        self.stats = ServeStats()

    def _dev(self, a) -> torch.Tensor:
        """Host numpy array -> tensor on the engine's device."""
        return torch.as_tensor(a, device=self.device)

    # ------------------------------------------------------------------ #
    def serve(self, requests: List[List[int]],
              max_new_tokens: int) -> List[List[int]]:
        """Serve ragged requests with the continuous scheduler."""
        return self.serve_continuous(requests, max_new_tokens)

    # ------------------------------------------------------------------ #
    def serve_continuous(self, requests: List[List[int]],
                         max_new_tokens: int) -> List[List[int]]:
        """Continuous batching over the paged, tiered, prefix-shared KV
        pool with chunked prefill.

        Each step spends at most ``prefill_budget`` tokens advancing
        PREFILLING slots by fixed-size chunks, then runs one fused
        ``decode_lookahead``-step decode block over the RUNNING slots
        (on-device greedy sampling + EOS latch, KV pages reserved ahead
        all-or-nothing, one host sync per block). Prompts sharing an
        already-seen prefix skip both the recompute and the pages
        (refcounted reuse; COW on mid-page divergence)."""
        ps, n_pp = self.page_size, self.n_pages_per_seq
        B = self.max_batch
        C = self.prefill_chunk
        # virtual stream clock, t = 0 at serve start: a prefill worker and a
        # decode worker, each an in-order ``VirtualStream`` charging its
        # ops' measured wall time plus any absorbed migration stall. With
        # overlap the streams advance independently and the makespan is
        # ``max(free)``; without, both names bind one stream.
        pstream = VirtualStream("prefill")
        dstream = VirtualStream("decode") if self.overlap else pstream
        # the prefill -> decode ready queue: rid -> virtual instant its
        # last prefill chunk finished
        decode_ready: Dict[int, float] = {}
        # a preemption victim's re-prefill cannot begin before the instant
        # of the reservation that evicted it
        svc_floor: Dict[int, float] = {}
        # scheduler clock: admissions stamp at the lagging stream's horizon;
        # during a decode-side reservation it is pinned to the block start
        sched_t = [0.0]

        def now() -> float:
            return max(sched_t[0], min(pstream.free, dstream.free))

        # structured trace: one recorder per serve; ServeStats is audited
        # against it when the run finishes (reconcile below)
        trace = TraceRecorder()
        self.trace = trace
        snap_stall = self.stats.stall_s
        snap_ttft, snap_itl = len(self.stats.ttft), len(self.stats.itl)
        snap_tokens = self.stats.new_tokens
        snap_srid = dict(self.stats.stall_by_rid)
        device = (SimulatedTierDevice.from_hierarchy(
                      self._tier_device_args[0], self._tier_device_args[1],
                      bw_gbps=self._tier_device_args[2],
                      latency_us=self._tier_device_args[3],
                      duplex=(self.writeback_link == "dedicated"))
                  if self._tier_device_args is not None else None)
        if device is not None:
            device.tracer = trace
        cdev = (SimulatedTierDevice.from_hierarchy(
                    self._chiplet_device_args[0],
                    self._chiplet_device_args[1],
                    bw_gbps=self._chiplet_device_args[2],
                    latency_us=self._chiplet_device_args[3],
                    link="chiplet")
                if self._chiplet_device_args is not None else None)
        if cdev is not None:
            cdev.tracer = trace
        kv = PagedKVManager(self.n_pages, ps, tier_budget=self.tier_budget,
                            enable_prefix_cache=self.prefix_cache,
                            dtype_bytes=self.kv_dtype_bytes,
                            page_nbytes=self.page_nbytes_shard,
                            tier_device=device, chiplet_device=cdev,
                            tracer=trace)
        self.kv_manager = kv
        sched = ContinuousScheduler(kv, B, prefill_chunk=C,
                                    prefill_budget=self.prefill_budget,
                                    tracer=trace, clock=now)
        cache = init_paged_cache(self.cfg, kv.n_pages, ps, self.opts,
                                 self.device)
        calibrated = self.opts.cache_dtype != "int8"  # only int8 calibrates

        def stall_plan(reqs: List[Request], t0: float):
            """Pre-kernel half of the fetch-wait barrier: decide swaps and
            spills now, defer the demand-fetch issue until the kernel's
            wall time is known (layer-sliced fetch)."""
            return kv.plan_residency([r.rid for r in reqs], t0)

        def stall_charge(plan, reqs: List[Request], t0: float, dw: float,
                         track: str) -> float:
            """Post-kernel half: issue the planned fetch, compute the
            pipelined stall and attribute it to the requests whose pages
            gated it."""
            per: Dict[int, float] = {}
            s, barrier = kv.charge_residency(
                plan, t0, n_slices=self.n_layer_slices, compute_s=dw,
                per_seq=per)
            if s > 0:
                self.stats.stall_s += s
            self.stats.stall_saved_s += max(0.0, barrier - s)
            trace.absorbed_stall(t0, s, track=track)
            for r in reqs:
                v = per.get(r.rid, 0.0)
                if v > 0:
                    r.stall_s += v
                    self.stats.stall_by_rid[r.rid] = (
                        self.stats.stall_by_rid.get(r.rid, 0.0) + v)
                    trace.span(r.rid, STALL, t0, t0 + v)
            return s

        for i, r in enumerate(requests):
            total = len(r) + max_new_tokens
            if total > self.max_len:
                raise ValueError(f"request {i}: prompt({len(r)}) + "
                                 f"new({max_new_tokens}) exceeds "
                                 f"max_len={self.max_len}")
            req = Request(rid=i, prompt=list(r),
                          max_new_tokens=max_new_tokens)
            req.t_submit = now()
            trace.submit(req.rid, req.t_submit)
            sched.submit(req)

        def finished(req: Request, tok: int) -> bool:
            return (req.remaining <= 0
                    or (self.eos_id is not None and tok == self.eos_id))

        def emit(req: Request, tok: int, at: float) -> float:
            # ``at``: attributed emission time on the issuing stream —
            # fused blocks spread their span evenly over produced tokens
            if not req.out:                      # very first token: TTFT
                self.stats.ttft.append(at - req.t_submit)
            elif req.t_last:
                self.stats.itl.append(at - req.t_last)
            req.t_last = at
            req.out.append(tok)
            self.stats.new_tokens += 1
            trace.token(req.rid, at, tok)
            return at

        def note_peak():
            if (self.tier_budget is not None
                    and kv.n_used >= self.stats.peak_pages_used):
                self.stats.kv_split_at_peak = kv.kv_tier_split()
            self.stats.peak_pages_used = max(self.stats.peak_pages_used,
                                             kv.n_used)
            self.stats.peak_fast_pages = max(self.stats.peak_fast_pages,
                                             kv.fast_pages_used)

        def apply_copies():
            nonlocal cache
            pairs = kv.drain_copies()
            if pairs:
                # pad to a power-of-two batch with null-page self-copies
                pairs = _pad_pow2(pairs, (0, 0))
                cache = copy_pages(cache, self._dev(np.asarray(pairs,
                                                               np.int32)))

        while sched.has_work:
            admitted = sched.admit()
            if admitted:
                # start migrating any offload-resident cached-prefix pages
                # toward the fast tiers before their first prefill chunk
                kv.prefetch_seqs([r.rid for _, r in admitted], now())
            apply_copies()       # COW copies must land before any KV write

            # ---- prefill worker: chunked, bounded by the budget ---- #
            budget = sched.prefill_budget
            for slot, req in sched.prefilling():
                if budget < C:
                    break
                pf = req.prefill_tokens
                F = len(pf)
                while budget >= C and req.state == PREFILLING:
                    start = req.n_prefilled
                    n_real = min(C, F - start)
                    toks = np.zeros((1, C), np.int32)
                    toks[0, :n_real] = pf[start:start + n_real]
                    pt = kv.table_row(req.rid, n_pp)[None]
                    self._chunk_shapes.add(((1, C), not calibrated))
                    t0 = pstream.start(svc_floor.get(req.rid, 0.0))
                    plan = stall_plan([req], t0)
                    w0 = time.perf_counter()
                    logits, cache = prefill_paged_chunk(
                        self.cfg, self.params, self._dev(toks), cache,
                        self._dev(np.asarray(pt, np.int32)), start,
                        self._dev(np.asarray([start + n_real], np.int32)),
                        self.opts, calibrate=not calibrated)
                    _sync(self.device)   # the bracket ends with the chunk
                    dw = time.perf_counter() - w0
                    s = stall_charge(plan, [req], t0, dw, "prefill")
                    self.stats.host_syncs += 1
                    calibrated = True
                    t1 = pstream.commit(t0, s + dw)
                    self.stats.prefill_s += t1 - t0
                    trace.engine_span(
                        "prefill_chunk", t0, t1,
                        {"rid": req.rid, "tokens": [start, start + n_real]},
                        track="prefill")
                    trace.prefill_span(req.rid, t0, t1, start,
                                       start + n_real)
                    self.stats.prefill_tokens_computed += n_real
                    budget -= C
                    req.n_prefilled = start + n_real
                    kv.mark_written(req.rid, req.n_prefilled)
                    # index finished full pages right away so concurrent
                    # shared-prefix admissions hit them mid-prefill
                    kv.register_prefix(req.rid, pf,
                                       n_valid=req.n_prefilled)
                    if req.n_prefilled >= F:
                        sched.finish_prefill(slot)
                        decode_ready[req.rid] = t1   # decodable from t1
                        tok = int(np.argmax(
                            logits[0, F - 1 - start].float().cpu().numpy()))
                        # the first-token pull is its own device->host
                        # round trip, after the chunk's barrier sync
                        self.stats.host_syncs += 1
                        t_e = emit(req, tok, t1)
                        if finished(req, tok):
                            sched.retire(slot)
                            trace.retire(req.rid, t_e)

            running = sched.running()
            note_peak()
            if not running:
                if sched.has_work:
                    continue     # prefills advance / admissions retry
                break

            # ---- decode worker: one block over the READY running slots;
            # requests whose prefill finished after the block's start sit
            # it out (zero quota) and join the next block
            t0 = dstream.start(min(decode_ready.get(r.rid, 0.0)
                                   for _, r in running))
            parts = [(s, r) for s, r in running
                     if decode_ready.get(r.rid, 0.0) <= t0]

            # ---- reserve the block's KV writes up front (may preempt): K
            # lookahead writes per slot, all-or-nothing; LIFO preemption
            # may evict ANY slot — diff the full slot table
            K = self.decode_lookahead
            before = dict(sched.slots)
            sched_t[0] = t0       # evictions stamp at the block start
            for slot, req in parts:
                if slot in sched.slots:     # may have been preempted
                    sched.reserve_lookahead(slot, min(K, req.remaining))
            sched_t[0] = 0.0
            evicted = [r for s, r in before.items() if s not in sched.slots]
            for r in evicted:
                svc_floor[r.rid] = t0
            self.stats.preemptions += len(evicted)
            parts = [(s, r) for s, r in parts
                     if s in sched.slots and r.state == RUNNING]
            apply_copies()   # COW from reservations lands before the block
            note_peak()
            if not parts:
                continue

            # ---- one fused K-step decode block over the ready slots:
            # sampling, EOS latching and length advance run on the device;
            # one host sync per (B, K) block
            tokens = np.zeros((B,), np.int32)
            seq_lens = np.zeros((B,), np.int32)
            tables = np.zeros((B, n_pp), np.int32)
            quota = np.zeros((B,), np.int32)
            inactive = np.ones((B,), bool)
            for slot, req in parts:
                tokens[slot] = req.out[-1]
                seq_lens[slot] = kv.seq_len(req.rid)  # write position
                tables[slot] = kv.table_row(req.rid, n_pp)
                quota[slot] = min(K, req.remaining)
                inactive[slot] = False
            # clamp the block to the largest live quota, rounded up to a
            # power of two: a tail block runs short instead of decoding
            # wasted pad steps
            n_steps = min(K, _next_pow2(int(quota.max())))
            self._decode_shapes.add(("paged", B, n_steps))
            # fetch-wait barrier: every page this block attends over must
            # be fast-resident (or its layer slice landed) before the layer
            # consumes it; the residual is recorded as stall
            plan = stall_plan([r for _, r in parts], t0)
            w0 = time.perf_counter()
            blk, cache = decode_steps_paged(
                self.cfg, self.params, self._dev(tokens),
                self._dev(seq_lens), self._dev(tables), cache, n_steps,
                self.opts, eos_id=self.eos_id, done=self._dev(inactive),
                quota=self._dev(quota))
            blk_np = blk.cpu().numpy()     # the block's one host pull
            dw = time.perf_counter() - w0
            s = stall_charge(plan, [r for _, r in parts], t0, dw, "decode")
            tv = dstream.commit(t0, s + dw)
            dt = tv - t0
            trace.engine_span("decode_block", t0, tv,
                              {"n_steps": n_steps, "n_seqs": len(parts)},
                              track="decode")
            self.stats.host_syncs += 1
            self.stats.decode_s += dt
            self.stats.decode_steps += n_steps

            # distribute the block: per-token ITL is attributed evenly from
            # the block wall time; retire/commit at boundaries
            for slot, req in parts:
                fin = False
                n_written = 0            # device-side KV writes taken
                for j in range(int(quota[slot])):
                    tok = int(blk_np[slot, j])
                    n_written += 1
                    emit(req, tok, at=t0 + dt * (j + 1) / n_steps)
                    if finished(req, tok):
                        fin = True
                        break
                t_end = t0 + dt * (n_written / n_steps)
                trace.span(req.rid, DECODE, t0, t_end)
                kv.commit_tokens(req.rid, n_written)
                if fin:
                    sched.retire(slot)   # frees surplus reserved pages
                    trace.retire(req.rid, t_end)

            # prefetch AHEAD of the next block, backdated to this block's
            # launch; when the fetch channel would otherwise sit idle, the
            # lookahead arg also promotes the deepest still-prefilling
            # sequence's pages
            cont = [r.rid for s, r in running if s in sched.slots]
            if cont:
                kv.prefetch_seqs(cont, t0, lookahead_seqs=[
                    r.rid for _, r in sched.prefilling()])

        self.stats.requests += len(requests)
        self.stats.cached_prefix_tokens += kv.dedup_tokens
        self.stats.pages_deduped += kv.dedup_hits
        self.stats.cow_copies += kv.cow_copies
        self.stats.spill_bytes += kv.spill_bytes
        self.stats.fetch_bytes += kv.fetch_bytes
        self.stats.pages_spilled += kv.n_spills
        self.stats.pages_fetched += kv.n_fetches
        self.stats.prefetch_hits += kv.prefetch_hits
        self.stats.prefetch_misses += kv.prefetch_misses
        self.stats.clean_demotions += kv.clean_demotions
        self.stats.chiplet_promotions += kv.chiplet_promotions
        self.stats.chiplet_demotions += kv.chiplet_demotions
        for ch, nb in kv.channel_bytes.items():
            self.stats.channel_bytes[ch] = (
                self.stats.channel_bytes.get(ch, 0.0) + nb)
        for tier, n in kv.tier_touches.items():
            self.stats.tier_touches[tier] = (
                self.stats.tier_touches.get(tier, 0) + n)
        self.stats.prefill_compiles = len(self._chunk_shapes)
        self.stats.decode_compiles = len(self._decode_shapes)
        assert not sched.waiting and not sched.slots, "unserved requests"
        assert kv.n_used == 0, "page leak: retired sequences kept pages"
        self.stats.serve_s += max(pstream.free, dstream.free)
        # close the trace and audit the aggregate counters against it
        # (raises on drift)
        trace.finalize(max(pstream.free, dstream.free))
        self.trace_report = trace.reconcile(
            stall_s=self.stats.stall_s - snap_stall,
            ttft=self.stats.ttft[snap_ttft:],
            itl=self.stats.itl[snap_itl:],
            new_tokens=self.stats.new_tokens - snap_tokens,
            stall_by_rid={rid: v - snap_srid.get(rid, 0.0)
                          for rid, v in self.stats.stall_by_rid.items()},
            channel_bytes=dict(kv.channel_bytes))
        by_rid = {req.rid: req.out for req in sched.done}
        return [by_rid[i] for i in range(len(requests))]
