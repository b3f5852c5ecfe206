"""Serve engines over the tiered KV cache, in PyTorch (the reference is
``repro/serving/engine.py``).

``ServeEngine(scheduler="continuous")``: iteration-level batching over a
pool of fixed-size KV pages (native or int8), shared-prefix page reuse
with copy-on-write, chunked prefill, a fused K-step decode block with one
host sync per block, greedy or sampled (temperature/top-k/top-p) on the
device, and speculative decoding (``spec_mode="ngram"`` or ``"model"``:
propose, one verify pass, leftover/rejection sampling, rollback of the
rejected suffix). Page residency across a ``MemoryHierarchy`` (HBS
offload, chiplet promotion) is charged on a virtual clock exactly as in
the reference. On the card every prefill chunk, decode step and verify
pass attends through the paged kernels of ``kernels.decode_attention``.

``ServeEngine(scheduler="static")``: waves of equal-length prompts over a
dense per-wave KV cache (native or int8, int8 scales set afresh by each
wave's prefill); ``generate`` prefills the wave (flash attention) and
decodes it in fused K-step greedy blocks (dense decode attention), or
token by token when sampling; ``serve_bucketed`` groups ragged requests
by length into waves.

Sampling draws come from ``models.sampling``'s counter-based generator
keyed by ``(sample_seed, rid, token index)``, not JAX's threefry keys: at
temperature 0 outputs are token-identical to the reference, above it they
agree in distribution.

CUDA work is asynchronous, so each timed bracket closes after the host
pull (or a ``torch.cuda.synchronize()``) that ends it: ``prefill_s``,
``decode_s`` and the virtual clock measure kernel time, not launch time.

Both engines serve the dense and the mixture-of-experts decoders (causal
GQA/MHA attention; the MoE FFN's dispatch is ``RuntimeOptions.moe_impl``,
capacity-dropped by default as in the reference). The static engine also
serves every other family of ``models.api``: the VLMs, MLA with
DeepSeek-V2's dense prefix layer, Mamba-2, the Zamba2 hybrid and the
Whisper encoder-decoder; the continuous engine refuses them with the
reference's ``paged_supported`` reasons.

``ServeEngine(shards=N, scheduler="continuous")`` serves head-sharded
(DESIGN.md SS16) under ``torch.distributed``: N ranks, one process each
(``launch.ranks.run_ranks``), build the same engine and run the same host
code; each holds ``Hkv/N`` KV heads of every page and attends over them
through ``kernels.sharded``, so tokens are bitwise those of ``shards=1``
on every rank. The ranks agree on every measured wall time (the slowest
rank's), so their virtual clocks, and hence their schedules, stay equal.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import sharded as ksh
from repro_torch.models import (RuntimeOptions, copy_pages, decode_step,
                                decode_steps, decode_steps_paged, init_cache,
                                init_paged_cache, init_params,
                                kernel_width_reason, layer_dma_slices,
                                paged_supported, prefill,
                                prefill_paged_chunk, resolve_device,
                                spec_decode_verify, static_supported,
                                torch_dtype)
from repro_torch.models import sampling
from repro_torch.serving import metrics
from repro_torch.serving.kv_manager import (PagedKVManager,
                                            SimulatedTierDevice, TierBudget,
                                            page_bytes)
from repro_torch.serving.scheduler import (PREFILLING, RUNNING,
                                           AdaptiveSpecK, ContinuousScheduler,
                                           Request)
from repro_torch.serving.streams import VirtualStream
from repro_torch.serving.trace import DECODE, DRAFT, STALL, TraceRecorder


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
    # speculative decoding
    draft_proposed: int = 0             # draft tokens fed to verify passes
    draft_accepted: int = 0             # draft tokens the target kept
    spec_blocks: int = 0                # verify passes run
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
        if kv_policy not in ("native", "int8"):
            raise ValueError(f"kv_policy must be 'native' or 'int8', got "
                             f"{kv_policy!r}")
        if kv_policy == "int8":
            opts = dataclasses.replace(opts, cache_dtype="int8")
        # a head width that a kernel of the path does not take is refused
        # here, before any weights are drawn or ranks spawned, rather than
        # at the first launch (the CPU's plain versions take any width)
        if torch.device(device).type == "cuda":
            paths = [(cfg, "paged" if scheduler == "continuous"
                      else "static")]
            if spec_mode == "model" and draft_cfg is not None:
                paths.append((draft_cfg, "paged"))
            for c, path in paths:
                reason = kernel_width_reason(c, path)
                if reason:
                    raise NotImplementedError(reason)
        # ---- head-sharded serving (DESIGN.md SS16) ---- #
        # N ranks of a process group each hold Hkv/N heads of every page
        # and run the unchanged kernels on them; head outputs are
        # all-gathered, so outputs stay bitwise those of shards=1 while a
        # device's page bytes shrink by N
        if shards < 1:
            raise ValueError(f"shards ({shards}) must be >= 1")
        self.shard = None
        if shards > 1:
            if scheduler != "continuous":
                raise ValueError("head-sharded serving (shards > 1) runs "
                                 "on the paged continuous engine; use "
                                 "scheduler='continuous'")
            if cfg.n_kv_heads % shards:
                raise ValueError(f"shards ({shards}) must divide "
                                 f"n_kv_heads ({cfg.n_kv_heads}) for head "
                                 f"sharding")
            self.shard = ksh.ShardGroup.from_world(shards, device)
            device = self.shard.device
            opts = dataclasses.replace(opts, kv_shard=self.shard)
        self.device = resolve_device(device)
        if scheduler not in ("static", "continuous"):
            raise ValueError(f"unknown scheduler {scheduler!r}")
        # ---- speculative decoding / sampling configuration ---- #
        if spec_mode not in ("off", "ngram", "model"):
            raise ValueError(f"spec_mode must be one of off|ngram|model, "
                             f"got {spec_mode!r}")
        if spec_mode != "off" and scheduler != "continuous":
            raise ValueError("speculative decoding runs on the paged "
                             "continuous engine; use scheduler='continuous' "
                             "or spec_mode='off'")
        if spec_mode != "off" and spec_k < 1:
            raise ValueError(f"spec_k ({spec_k}) must be >= 1")
        if spec_mode == "model" and draft_cfg is None:
            raise ValueError("spec_mode='model' needs a draft_cfg "
                             "(a small paged-KV-capable ArchConfig)")
        if draft_cfg is not None and spec_mode != "model":
            raise ValueError(f"draft_cfg is only meaningful with "
                             f"spec_mode='model' (got {spec_mode!r})")
        if temperature < 0.0:
            raise ValueError(f"temperature ({temperature}) must be >= 0")
        if top_k < 0:
            raise ValueError(f"top_k ({top_k}) must be >= 0")
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p ({top_p}) must be in (0, 1]")
        if temperature == 0.0 and (top_k or top_p < 1.0):
            raise ValueError("top_k/top_p filter a stochastic sample; they "
                             "need temperature > 0 (temperature 0 is greedy)")
        if scheduler == "continuous":
            reason = paged_supported(cfg)
            if reason:
                raise NotImplementedError(
                    f"continuous scheduler needs the paged KV path: {reason}")
        else:
            reason = static_supported(cfg)
            if reason:
                raise NotImplementedError(
                    f"static scheduler needs the dense-cache path: {reason}")
        self.spec_mode = spec_mode
        self.spec_k = spec_k
        self.draft_cfg = draft_cfg
        self.draft_params = draft_params
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.sample_seed = sample_seed
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
            gen = torch.Generator(device=self.device).manual_seed(seed)
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
        self.drafter = None     # the last serve's draft proposer, if any
        # structured trace of the LAST serve_continuous run, plus its
        # reconcile report (trace audited against ServeStats deltas)
        self.trace: Optional[TraceRecorder] = None
        self.trace_report: Optional[dict] = None
        self.stats = ServeStats()

    def _wall(self, w0: float) -> float:
        """Wall seconds since ``w0``; on a head shard the slowest rank's,
        so every rank charges the same time to its virtual clock."""
        dw = time.perf_counter() - w0
        return dw if self.shard is None else ksh.agree_max(self.shard, dw)

    def _dev(self, a) -> torch.Tensor:
        """Host numpy array -> tensor on the engine's device."""
        return torch.as_tensor(a, device=self.device)

    def _slot_keys(self, parts, n_slots: int) -> torch.Tensor:
        """(n_slots, 2) sampling keys of the (slot, request) ``parts`` at
        each request's next token index (idle slots get rid 0): a
        request's draws depend on (sample_seed, rid, tokens emitted) only,
        never on batch composition, and survive recompute preemption."""
        rids = np.zeros((n_slots,), np.int64)
        emitted = np.zeros((n_slots,), np.int64)
        for slot, req in parts:
            rids[slot] = req.rid
            emitted[slot] = len(req.out)
        return sampling.request_keys(self.sample_seed, self._dev(rids),
                                     self._dev(emitted))

    # ------------------------------------------------------------------ #
    def generate(self, prompts, max_new_tokens: int, *, prefix_emb=None,
                 greedy: bool = True, seed: int = 0,
                 noise=None) -> List[List[int]]:
        """One static wave. prompts: (B, S) int array (equal lengths);
        prefix_emb: (B, P, d) stub frontend output, or None: VLM patches
        prepended to every prompt's embeddings, or an encoder-decoder's
        frames. It counts toward max_len, and decode positions start after
        it for every family, as in the reference: so an encoder-decoder
        decodes at S + P onward, P zero rows of its self cache stay inside
        the causal mask and its learned positions are read P rows late
        (ROADMAP.md queue C records this fault of the reference, which the
        port keeps to stay token-identical).

        Greedy decode runs in fused K-step blocks (``models.decode_steps``,
        K = ``decode_lookahead``): the host pulls one (B, K) token block a
        sync instead of one token, and a tail block is clamped to the next
        power of two of the tokens still owed. Emitted columns are the same
        for every K: a block may overrun EOS on the device, but the host
        truncates at exactly the step the per-token loop stops at.

        ``greedy=False`` samples one token a step from softmax(logits)
        (temperature 1, no filter) with one host sync a token, as
        ``argmax(logits + Gumbel noise)``: step i's noise is ``noise[i]``
        ((B, vocab) arrays, so a test can hand in the reference's own
        draws), or else the counter-based draws of ``(seed, row, i)``."""
        prompts = torch.as_tensor(np.asarray(prompts), dtype=torch.int32,
                                  device=self.device)
        B, S = prompts.shape
        pfx = prefix_emb.shape[1] if prefix_emb is not None else 0
        total = S + pfx + max_new_tokens
        if total > self.max_len:
            raise ValueError(f"prompt({S}) + prefix({pfx}) + new("
                             f"{max_new_tokens}) = {total} exceeds "
                             f"max_len={self.max_len}")
        if prefix_emb is not None and not torch.is_tensor(prefix_emb):
            prefix_emb = torch.as_tensor(np.asarray(prefix_emb))
        cfg, params, opts = self.cfg, self.params, self.opts
        K = self.decode_lookahead if greedy else 1
        n_blocks = -(-max(max_new_tokens - 1, 0) // K)
        # the last fused block may overrun the token budget: headroom keeps
        # its (discarded) writes inside the cache
        cache = init_cache(cfg, B, S + pfx + 1 + n_blocks * K, opts,
                           self.device)

        t0 = time.perf_counter()
        logits, cache = prefill(cfg, params, prompts, cache, opts,
                                prefix_emb=prefix_emb)
        _sync(self.device)
        self.stats.host_syncs += 1
        self.stats.prefill_s += time.perf_counter() - t0

        out: List[np.ndarray] = []
        done = np.zeros((B,), bool)
        t0 = time.perf_counter()
        launched = 0                        # device decode micro-steps
        if greedy:
            tok = sampling.sample_greedy(logits)
            pending = tok[:, None]          # device columns not yet pulled
            n_sent = 1                      # tokens produced on device
            stop = False
            while True:
                cols = pending.cpu().numpy()
                self.stats.host_syncs += 1
                for j in range(cols.shape[1]):
                    if len(out) >= max_new_tokens:
                        break
                    out.append(cols[:, j])
                    if self.eos_id is not None:
                        done |= cols[:, j] == self.eos_id
                        if done.all():
                            stop = True
                            break
                if stop or len(out) >= max_new_tokens:
                    break
                k_eff = min(K, _next_pow2(max_new_tokens - len(out)))
                self._decode_shapes.add(("dense", B, k_eff))
                pending, cache = decode_steps(cfg, params, tok,
                                              S + pfx + n_sent - 1, cache,
                                              k_eff, opts)
                tok = pending[:, -1]
                n_sent += k_eff
                launched += k_eff
        else:
            rows = torch.arange(B, device=self.device)
            for i in range(max_new_tokens):
                if noise is not None:
                    g = torch.as_tensor(np.array(noise[i], np.float32),
                                        device=self.device)
                else:
                    g = sampling.gumbel(sampling.request_keys(
                        seed, rows, torch.full_like(rows, i)),
                        logits.shape[-1])
                tok = sampling.sample(logits, g, temperature=1.0)
                out.append(tok.cpu().numpy())
                self.stats.host_syncs += 1
                if self.eos_id is not None:
                    done |= out[-1] == self.eos_id
                    if done.all():
                        break
                if i + 1 < max_new_tokens:
                    logits, cache = decode_step(cfg, params, tok,
                                                S + pfx + i, cache, opts)
                    launched += 1
        self.stats.decode_s += time.perf_counter() - t0
        self.stats.new_tokens += len(out) * B
        self.stats.requests += B
        # launched device micro-steps (may exceed emitted - 1: blocks can
        # overrun EOS), as the continuous engine counts them
        self.stats.decode_steps += launched
        self.stats.decode_compiles = len(self._decode_shapes)
        return [row.tolist() for row in np.stack(out, axis=1)]

    # ------------------------------------------------------------------ #
    def serve(self, requests: List[List[int]],
              max_new_tokens: int) -> List[List[int]]:
        """Serve ragged requests with the configured scheduler."""
        if self.scheduler == "continuous":
            return self.serve_continuous(requests, max_new_tokens)
        return self.serve_bucketed(requests, max_new_tokens)

    def serve_bucketed(self, requests: List[List[int]],
                       max_new_tokens: int) -> List[List[int]]:
        """Group ragged requests into equal-length waves, shortest first,
        and serve each with ``generate``."""
        buckets: Dict[int, List[int]] = {}
        for i, r in enumerate(requests):
            buckets.setdefault(len(r), []).append(i)
        results: Dict[int, List[int]] = {}
        for _, idxs in sorted(buckets.items()):
            outs = self.generate([requests[i] for i in idxs], max_new_tokens)
            for i, o in zip(idxs, outs):
                results[i] = o
        return [results[i] for i in range(len(requests))]

    # ------------------------------------------------------------------ #
    def serve_continuous(self, requests: List[List[int]],
                         max_new_tokens: int) -> List[List[int]]:
        """Continuous batching over the paged, tiered, prefix-shared KV
        pool with chunked prefill.

        Each step spends at most ``prefill_budget`` tokens advancing
        PREFILLING slots by fixed-size chunks, then runs one fused
        ``decode_lookahead``-step decode block over the RUNNING slots
        (on-device greedy or sampled choice + EOS latch, KV pages
        reserved ahead all-or-nothing, one host sync per block) — or,
        with ``spec_mode`` on, one draft proposal and one verify pass
        that lands the accepted prefix plus one token. Prompts sharing an
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
        # draft proposer + acceptance-adaptive window sizing; fresh per
        # serve() so lookup indices / draft KV never leak across runs
        draft = adaptive = None
        if self.spec_mode == "ngram":
            from repro_torch.serving.draft import NGramDraft
            draft = NGramDraft()
            adaptive = AdaptiveSpecK(self.spec_k)
        elif self.spec_mode == "model":
            from repro_torch.serving.draft import ModelDraft
            # the draft runs in the target's working dtype with a native
            # cache (the reference's draft always runs in f32)
            draft = ModelDraft(self.draft_cfg, self.draft_params,
                               RuntimeOptions(dtype=self.opts.dtype),
                               page_size=ps, max_batch=B,
                               max_len=self.max_len, device=self.device)
            self.draft_params = draft.params    # reuse across serve() calls
            adaptive = AdaptiveSpecK(self.spec_k)
        self.drafter = draft
        if draft is not None:
            draft.tracer, draft.clock = trace, now
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
                    dw = self._wall(w0)
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
                        if self.temperature > 0:
                            # the token after a (re-)prefill: drawn at the
                            # request's own next token index (0 unless a
                            # preemption is being recomputed)
                            keys = self._slot_keys([(0, req)], 1)
                            lg = logits[:, F - 1 - start]
                            tok = int(sampling.sample(
                                lg, sampling.gumbel(keys, lg.shape[-1]),
                                temperature=self.temperature,
                                top_k=self.top_k, top_p=self.top_p)[0])
                        else:
                            tok = int(np.argmax(logits[0, F - 1 - start]
                                                .float().cpu().numpy()))
                        # the first-token pull is its own device->host
                        # round trip, after the chunk's barrier sync
                        self.stats.host_syncs += 1
                        t_e = emit(req, tok, t1)
                        if finished(req, tok):
                            sched.retire(slot)
                            trace.retire(req.rid, t_e)
                            if draft is not None:
                                draft.drop(req.rid)

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

            if self.spec_mode != "off":
                # ==== speculative decode block ==== #
                # the draft proposes up to k tokens per request; ONE verify
                # pass streams weights+KV once and lands n_acc+1 tokens
                items = [(req, min(adaptive.k_for(req), req.remaining - 1))
                         for _, req in parts]
                w0 = time.perf_counter()
                # a model draft ends with its proposed block's host pull;
                # the n-gram draft is host-only and reports zero syncs
                props = draft.propose_all(items)
                self.stats.host_syncs += draft.take_host_syncs()
                td = dstream.commit(t0, self._wall(w0))
                trace.engine_span("spec_propose", t0, td,
                                  {"n_seqs": len(items)}, track="decode")
                for _, r in parts:
                    # the whole batch waits out the proposal pass
                    trace.span(r.rid, DRAFT, t0, td)
                # reserve draft_len+1 KV writes per slot, all-or-nothing;
                # LIFO preemption may evict ANY slot — diff the full table
                before = dict(sched.slots)
                sched_t[0] = td       # evictions stamp at reservation time
                for slot, req in parts:
                    if slot in sched.slots:
                        sched.reserve_lookahead(
                            slot, len(props.get(req.rid, ())) + 1)
                sched_t[0] = 0.0
                evicted = [r for s, r in before.items()
                           if s not in sched.slots]
                for r in evicted:
                    svc_floor[r.rid] = td
                self.stats.preemptions += len(evicted)
                parts = [(s, r) for s, r in parts
                         if s in sched.slots and r.state == RUNNING]
                apply_copies()
                note_peak()
                if not parts:
                    continue
                # clamp the verify window to the largest live draft,
                # rounded up to a power of two
                max_dl = max(len(props.get(r.rid, ())) for _, r in parts)
                n_tok = min(self.spec_k + 1, _next_pow2(max_dl + 1))
                tokens = np.zeros((B, n_tok), np.int32)
                draft_len = np.zeros((B,), np.int32)
                seq_lens = np.zeros((B,), np.int32)
                tables = np.zeros((B, n_pp), np.int32)
                for slot, req in parts:
                    pr = list(props.get(req.rid, ()))[:n_tok - 1]
                    tokens[slot, 0] = req.out[-1]
                    if pr:
                        tokens[slot, 1:1 + len(pr)] = pr
                    draft_len[slot] = len(pr)
                    seq_lens[slot] = kv.seq_len(req.rid)  # landed extent
                    tables[slot] = kv.table_row(req.rid, n_pp)
                self._decode_shapes.add(("spec", B, n_tok))
                tb = dstream.start()
                plan = stall_plan([r for _, r in parts], tb)
                w0 = time.perf_counter()
                keys = (self._slot_keys(parts, B) if self.temperature > 0
                        else None)
                out, n_acc, cache = spec_decode_verify(
                    self.cfg, self.params, self._dev(tokens),
                    self._dev(draft_len), self._dev(seq_lens),
                    self._dev(tables), cache, keys, self.opts,
                    temperature=self.temperature, top_k=self.top_k,
                    top_p=self.top_p)
                # the pass's one host pull: tokens and n_acc together
                res = torch.cat([out, n_acc[:, None]], dim=1).cpu().numpy()
                out_np, nacc_np = res[:, :-1], res[:, -1]
                dw = self._wall(w0)
                s = stall_charge(plan, [r for _, r in parts], tb, dw,
                                 "decode")
                tv = dstream.commit(tb, s + dw)
                dt = tv - t0
                trace.engine_span("spec_verify", tb, tv,
                                  {"n_tok": n_tok, "n_seqs": len(parts)},
                                  track="decode")
                self.stats.host_syncs += 1
                self.stats.decode_s += dt
                self.stats.decode_steps += 1    # one streaming pass
                self.stats.spec_blocks += 1

                # distribute: accepted prefix + correction/bonus token; the
                # pass wall time is attributed evenly over emitted tokens;
                # rejected suffix pages roll back via commit_speculative
                for slot, req in parts:
                    dl = int(draft_len[slot])
                    acc = int(nacc_np[slot])
                    self.stats.draft_proposed += dl
                    self.stats.draft_accepted += acc
                    req.draft_proposed += dl
                    req.draft_accepted += acc
                    adaptive.update(req, dl, acc)
                    m = acc + 1
                    fin = False
                    n_written = 0
                    for j in range(m):
                        tok = int(out_np[slot, j])
                        n_written += 1
                        emit(req, tok, at=t0 + dt * (j + 1) / m)
                        if finished(req, tok):
                            fin = True
                            break
                    t_end = t0 + dt * (n_written / m)
                    trace.span(req.rid, DECODE, t0, t_end)
                    trace.instant("spec_commit", t_end, rid=req.rid,
                                  args={"proposed": dl, "accepted": acc})
                    kv.commit_speculative(req.rid, n_written)
                    if fin:
                        sched.retire(slot)
                        trace.retire(req.rid, t_end)
                        draft.drop(req.rid)
            else:
                # ---- reserve the block's KV writes up front (may
                # preempt): K lookahead writes per slot, all-or-nothing;
                # LIFO preemption may evict ANY slot — diff the full table
                K = self.decode_lookahead
                before = dict(sched.slots)
                sched_t[0] = t0       # evictions stamp at the block start
                for slot, req in parts:
                    if slot in sched.slots:     # may have been preempted
                        sched.reserve_lookahead(slot, min(K, req.remaining))
                sched_t[0] = 0.0
                evicted = [r for s, r in before.items()
                           if s not in sched.slots]
                for r in evicted:
                    svc_floor[r.rid] = t0
                self.stats.preemptions += len(evicted)
                parts = [(s, r) for s, r in parts
                         if s in sched.slots and r.state == RUNNING]
                apply_copies()   # COW from reservations lands pre-block
                note_peak()
                if not parts:
                    continue

                # ---- one fused K-step decode block over the ready slots:
                # sampling, EOS latching and length advance run on the
                # device; one host sync per (B, K) block
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
                # clamp the block to the largest live quota, rounded up to
                # a power of two: a tail block runs short instead of
                # decoding wasted pad steps
                n_steps = min(K, _next_pow2(int(quota.max())))
                self._decode_shapes.add(("paged", B, n_steps))
                # fetch-wait barrier: every page this block attends over
                # must be fast-resident (or its layer slice landed) before
                # the layer consumes it; the residual is recorded as stall
                plan = stall_plan([r for _, r in parts], t0)
                w0 = time.perf_counter()
                keys = (self._slot_keys(parts, B) if self.temperature > 0
                        else None)
                blk, cache = decode_steps_paged(
                    self.cfg, self.params, self._dev(tokens),
                    self._dev(seq_lens), self._dev(tables), cache, n_steps,
                    self.opts, eos_id=self.eos_id,
                    temperature=self.temperature, top_k=self.top_k,
                    top_p=self.top_p, keys=keys,
                    done=self._dev(inactive), quota=self._dev(quota))
                blk_np = blk.cpu().numpy()     # the block's one host pull
                dw = self._wall(w0)
                s = stall_charge(plan, [r for _, r in parts], t0, dw,
                                 "decode")
                tv = dstream.commit(t0, s + dw)
                dt = tv - t0
                trace.engine_span("decode_block", t0, tv,
                                  {"n_steps": n_steps,
                                   "n_seqs": len(parts)}, track="decode")
                self.stats.host_syncs += 1
                self.stats.decode_s += dt
                self.stats.decode_steps += n_steps

                # distribute the block: per-token ITL is attributed evenly
                # from the block wall time; retire/commit at boundaries
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
