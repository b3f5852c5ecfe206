"""Paged, tiered KV-cache manager with shared-prefix page reuse and real
per-page tier residency (DESIGN.md SS10/SS11/SS13).

The runtime half of the paper's capacity-pressure story: the KV cache is a
pool of fixed-size pages shared by all in-flight sequences, indirected
through per-sequence page tables. A ``TierBudget`` derived from a
``repro_torch.core.MemoryHierarchy`` caps the pool at what the hierarchy's KV
tiers can physically hold, and reports the pool's occupancy *as a tier
split* — the same ``((level, fraction), ...)`` shape the analytical
placement model consumes — so runtime admission pressure and analytical
spill predictions are computed from one source of truth.

Tier residency is *real*, not an accounting fiction (SS13): every
assigned page lives in exactly one tier of the budget, tracked in a
per-page residency map. New pages land in the fastest tier with room and
overflow into the slowest ("offload") tier; a block-aligned rebalance
pass (``prefetch_seqs`` / ``residency_stall``) promotes the pages a
scheduled sequence is about to attend over back into the fast tiers,
demoting LRU-cold pages to the offload tier to make room. Migration time
is charged by a ``SimulatedTierDevice`` in *virtual seconds* — per-batch
issue latency plus bytes/bandwidth on independent spill/fetch DMA
channels — so a decode block that outruns its prefetch records the
residual as stall time instead of silently winning. The page payloads
themselves never move (the device pool is one array); only the residency
map and the virtual clock change, which keeps offload runs token-identical
to no-offload runs by construction.

Prefix sharing (SS11) attacks the capacity term directly: pages are
refcounted, full pages of completed prefixes are registered in a
hash-chained index (block content + every block before it), and a new
request whose prompt matches a chain *reuses the physical pages* instead
of recomputing and re-storing identical KV. Divergence mid-page is handled
copy-on-write: the manager hands the sequence a private copy of the
partially-matching page and records the (src, dst) device copy for the
engine to apply. Retired prefixes stay cached at refcount 0 (evictable,
LRU) until allocation pressure reclaims them.

Host-side bookkeeping is plain Python (free list + dicts); the page pool
arrays themselves live in the model cache (``models.init_paged_cache``).
Page 0 is reserved as the null page: padded page-table entries point at it,
inactive slots write into it, and nothing ever reads it unmasked.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.serving.channels import KV_TIER_NAMES, make_label

# tiers a KV page may occupy, preferred (fastest) first; mirrors the
# placement policies in repro.core.placement and the channel vocabulary
# in repro_torch.serving.channels (one table, no drift)
DEFAULT_KV_TIERS = KV_TIER_NAMES


def page_bytes(cfg: ArchConfig, page_size: int, dtype_bytes: int = 2) -> int:
    """Bytes one KV page holds across all layers (k + v)."""
    per_tok = 2 * cfg.n_kv_heads * cfg.head_dim * cfg.n_layers * dtype_bytes
    return per_tok * page_size


@dataclass
class SimulatedTierDevice:
    """Virtual-time migration engine between the fast KV tiers and the
    offload tier (DESIGN.md SS13).

    Two DMA channels — ``"in"`` (fetch: offload -> fast) and ``"out"``
    (spill/write-back: fast -> offload) — each a single queue whose busy
    horizon advances by the offload tier's issue latency once per
    *batched* migration plus ``bytes / bandwidth``. A dedicated-HBS link
    is full duplex (independent queues); a shared link (PCIe-attached
    SSD style, ``duplex=False``) serializes both directions through one
    queue, so write-back pressure delays fetches. All times are virtual
    seconds on the caller's clock (the engine passes
    ``perf_counter() + accumulated_stall``); the device never sleeps and
    never moves data — it only answers "when would this transfer have
    completed on real HBS", which the engine converts into decode stalls.
    """
    bandwidth: float                     # bytes/s across the offload link
    latency: float                       # seconds per migration batch issue
    tracer: Optional[object] = None      # TraceRecorder: DMA-track spans
    link: str = "hbs"                    # link name for trace track routing
    duplex: bool = True                  # False: in/out share one queue
    _free: Dict[str, float] = field(
        default_factory=lambda: {"in": 0.0, "out": 0.0, "io": 0.0})
    busy_s: Dict[str, float] = field(
        default_factory=lambda: {"in": 0.0, "out": 0.0})

    @classmethod
    def from_hierarchy(cls, hier, offload_tier: str, *,
                       bw_gbps: Optional[float] = None,
                       latency_us: Optional[float] = None,
                       duplex: bool = True,
                       link: Optional[str] = None
                       ) -> "SimulatedTierDevice":
        """Timing from the hierarchy's offload level, with CLI-style
        overrides (``bw_gbps`` in GB/s, ``latency_us`` in µs)."""
        lv = hier.level(offload_tier)
        bw = lv.bandwidth if bw_gbps is None else bw_gbps * 1e9
        lat = lv.latency if latency_us is None else latency_us * 1e-6
        if bw <= 0:
            raise ValueError(f"offload tier {offload_tier!r} needs a "
                             f"positive bandwidth, got {bw}")
        return cls(bandwidth=bw, latency=max(lat, 0.0),
                   duplex=duplex, link=link or offload_tier)

    def _qkey(self, channel: str) -> str:
        return channel if self.duplex else "io"

    def idle(self, channel: str, now: float) -> bool:
        """True when the channel's queue has drained by ``now``."""
        return self._free.get(self._qkey(channel), 0.0) <= now

    def transfer(self, channel: str, n_bytes: float, now: float,
                 label: Optional[str] = None) -> float:
        """Enqueue one batched migration; returns its completion time."""
        q = self._qkey(channel)
        start = max(self._free.get(q, 0.0), now)
        done = start + self.latency + n_bytes / self.bandwidth
        self.busy_s[channel] += done - start
        self._free[q] = done
        if self.tracer is not None:
            self.tracer.device_span(channel, start, done, n_bytes,
                                    link=self.link, label=label)
        return done

    def transfer_sliced(self, channel: str, n_bytes: float, now: float,
                        n_slices: int, label: Optional[str] = None
                        ) -> List[float]:
        """Enqueue one migration as a chained DMA descriptor of
        ``n_slices`` equal slices (DESIGN.md SS17: one slice per model
        layer). Issue latency is charged ONCE — the chain is a single
        queued command — and slice ``l`` completes at ``start + latency +
        (l+1) * bytes / (n_slices * bandwidth)``, so a consumer walking
        the slices in order (the layer loop) can start on slice 0 while
        the tail still streams. The final slice lands exactly when the
        equivalent bulk ``transfer`` would, which is what makes
        layer-overlap never worse than the whole-block barrier. Returns
        the per-slice completion times."""
        if n_slices <= 1:
            return [self.transfer(channel, n_bytes, now, label=label)]
        q = self._qkey(channel)
        start = max(self._free.get(q, 0.0), now)
        per = n_bytes / self.bandwidth / n_slices
        dones = [start + self.latency + (i + 1) * per
                 for i in range(n_slices)]
        self.busy_s[channel] += dones[-1] - start
        self._free[q] = dones[-1]
        if self.tracer is not None:
            prev = start
            for i, d in enumerate(dones):
                self.tracer.device_span(channel, prev, d,
                                        n_bytes / n_slices,
                                        link=self.link, label=label,
                                        slice_idx=i)
                prev = d
        return dones


@dataclass(frozen=True)
class TierBudget:
    """Per-tier page counts, preferred (fastest) tier first.

    The leading ``n_promote`` tiers are PROMOTION-ONLY cache levels
    (DESIGN.md SS17: the bonded global-buffer chiplet): fresh pages are
    never assigned there — residency is earned by the EMA hot-page
    promotion pass and lost by LRU demotion back to the base tier. The
    remaining ordered levels behave as before: fresh pages land in the
    fastest base tier with room and overflow into the last ("offload")
    tier."""
    tiers: Tuple[Tuple[str, int], ...]     # ((level_name, n_pages), ...)
    n_promote: int = 0                     # leading promotion-only levels

    def __post_init__(self):
        if not (0 <= self.n_promote < len(self.tiers)):
            raise ValueError(
                f"n_promote ({self.n_promote}) must leave at least one "
                f"base tier out of {len(self.tiers)}")

    @property
    def total_pages(self) -> int:
        return sum(n for _, n in self.tiers)

    @property
    def promote_tiers(self) -> Tuple[Tuple[str, int], ...]:
        return self.tiers[:self.n_promote]

    @property
    def base_tiers(self) -> Tuple[Tuple[str, int], ...]:
        return self.tiers[self.n_promote:]

    @property
    def offload_tier(self) -> Optional[str]:
        """The slowest tier — spill target when the faster tiers are over
        budget. None when the budget has a single base tier (a promotion
        cache is not spill capacity — nowhere to spill)."""
        return (self.tiers[-1][0]
                if len(self.tiers) - self.n_promote > 1 else None)

    @property
    def fast_pages(self) -> int:
        """Pages the non-offload ("fast") tiers hold together, promotion
        levels included."""
        if self.offload_tier is None:
            return self.total_pages
        return sum(n for _, n in self.tiers[:-1])

    @classmethod
    def from_hierarchy(cls, hier, cfg: ArchConfig, page_size: int,
                       dtype_bytes: int = 2,
                       kv_tiers: Sequence[str] = DEFAULT_KV_TIERS,
                       reserve_bytes: Dict[str, float] = None,
                       uncapped_pages: Optional[int] = None,
                       shards: int = 1) -> "TierBudget":
        """Pages per tier from the hierarchy's KV-eligible capacities.

        ``reserve_bytes`` subtracts non-KV residency (weights, activations)
        per level before converting the remainder to pages — e.g. the output
        of ``workload.resident_bytes`` routed through a placement. A tier
        with ``capacity=None`` has no physical page count; admission checks
        built on ``total_pages`` would be meaningless, so it raises unless
        the caller supplies an explicit ``uncapped_pages`` cap for it.

        ``shards``: head-sharded serving (DESIGN.md SS16). Each device of
        an N-way mesh holds 1/N of every page (its Hkv/N head slice), so
        the hierarchy describes ONE device and a page costs ``page_bytes /
        N`` against it — an N-device mesh admits ~N× the pages within the
        same per-chip fast budget (the paper's per-chip constraint, not a
        fictitious pooled one). Shards are symmetric, so one budget models
        every device.

        A KV tier that is a SIDE tier of the hierarchy (attached beside
        the chain via ``with_side_tier`` — the bonded chiplet in
        ``npu_hierarchy(chiplet=...)``) becomes a promotion-only level:
        leading side tiers set ``n_promote`` so fresh pages skip them and
        residency there is earned by the hot-page promotion pass."""
        if shards < 1:
            raise ValueError(f"shards ({shards}) must be >= 1")
        if cfg.n_kv_heads % shards:
            raise ValueError(f"shards ({shards}) must divide n_kv_heads "
                             f"({cfg.n_kv_heads})")
        pb = page_bytes(cfg, page_size, dtype_bytes) / shards
        reserve = reserve_bytes or {}
        tiers: List[Tuple[str, int]] = []
        for name in kv_tiers:
            try:
                lv = hier.level(name)
            except KeyError:
                continue
            cap = lv.capacity
            if cap is None:
                if uncapped_pages is None:
                    raise ValueError(
                        f"tier {name!r} has no capacity; pass an explicit "
                        f"uncapped_pages= cap (a made-up huge page count "
                        f"would make total_pages-based admission "
                        f"meaningless)")
                tiers.append((name, uncapped_pages))
                continue
            avail = max(cap - reserve.get(name, 0.0), 0.0)
            n = int(avail // pb)
            if n > 0:
                tiers.append((name, n))
        if not tiers:
            raise ValueError(
                f"no KV-eligible tier in {kv_tiers} can hold even one "
                f"{pb}-byte page")
        side = set(getattr(hier, "side_tiers", {}) or {})
        n_promote = 0
        while (n_promote < len(tiers) - 1
               and tiers[n_promote][0] in side):
            n_promote += 1
        return cls(tuple(tiers), n_promote=n_promote)


class PageAllocationError(RuntimeError):
    """Raised when the pool cannot satisfy an allocation (caller preempts)."""


@dataclass
class _SeqAlloc:
    pages: List[int] = field(default_factory=list)
    n_tokens: int = 0
    # tokens whose KV has actually been written ("landed"). Defaults to
    # n_tokens for direct-manager users (allocate == prefill imminent);
    # the chunked-prefill scheduler resets it via mark_written so pages
    # the prefill has not reached yet are capacity, not traffic.
    n_written: int = 0


@dataclass(frozen=True)
class PrefixAllocation:
    """Result of a prefix-aware allocation."""
    pages: Tuple[int, ...]       # the sequence's full page list
    n_cached: int                # leading tokens whose KV is already valid


@dataclass
class ResidencyPlan:
    """Pre-kernel half of the fetch-wait barrier (DESIGN.md SS17): tier
    swaps are done, write-back is charged, and the demand fetches are
    identified but NOT yet issued. Produced by ``plan_residency`` before
    a kernel launches; after the kernel the engine knows its measured
    compute time and calls ``charge_residency`` to issue the fetch —
    bulk, or layer-sliced when overlap is on — and convert only the
    un-hidden remainder into stall. Every plan must be charged exactly
    once (fetch byte accounting lives in the charge)."""
    seq_ids: Tuple[int, ...]
    need: List[int]              # content-bearing offload pages to fetch
    inflight_ready: float        # completion of earlier in-flight fetches


def _chain_digest(parent: bytes, block: Sequence[int]) -> bytes:
    """Position-aware content hash: a block's key commits to every token
    before it, so identical blocks at different depths never collide."""
    h = hashlib.sha256(parent)
    h.update(np.asarray(block, np.int64).tobytes())
    return h.digest()


class PagedKVManager:
    """Refcounted free-list page allocator with per-sequence page tables
    and an optional shared-prefix page cache.

    Invariants (tested): every page is free, evictable (cached at
    refcount 0), or referenced by >=1 sequence; ``n_free + n_evictable +
    n_used == n_pages - 1`` (page 0 reserved); a page's refcount equals the
    number of sequences holding it; ``free_seq`` drops exactly one
    reference per page the sequence held.
    """

    def __init__(self, n_pages: int, page_size: int, *,
                 tier_budget: Optional[TierBudget] = None,
                 enable_prefix_cache: bool = False,
                 dtype_bytes: int = 2,
                 page_nbytes: Optional[float] = None,
                 tier_device: Optional[SimulatedTierDevice] = None,
                 chiplet_device: Optional[SimulatedTierDevice] = None,
                 ema_decay: float = 0.5,
                 promote_threshold: float = 1.5,
                 tracer: Optional[object] = None):
        if tier_budget is not None:
            n_pages = min(n_pages, tier_budget.total_pages + 1)
        if n_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        self.n_pages = n_pages
        self.page_size = page_size
        self.tier_budget = tier_budget
        self.enable_prefix_cache = enable_prefix_cache
        # active KV element width (int8 cache -> 1); prices occupancy and
        # migration traffic — never hardcode 2 downstream of this
        self.dtype_bytes = dtype_bytes
        self.page_nbytes = float(page_nbytes or 0.0)
        self.tier_device = tier_device
        # optional TraceRecorder (SS15): prefetch hit/miss instants land on
        # the DMA-in track as they are consumed by the fetch-wait barrier
        self.tracer = tracer
        # --- per-page tier residency (SS13) --- #
        # every ASSIGNED page (referenced or cached-evictable) lives in
        # exactly one budget tier; free pages are unassigned
        self._tier: Dict[int, str] = {}
        self._tier_used: Dict[str, int] = (
            {name: 0 for name, _ in tier_budget.tiers}
            if tier_budget is not None else {})
        self._offload = (tier_budget.offload_tier
                         if tier_budget is not None else None)
        # promotion-only cache levels (SS17): the chiplet sits between the
        # base fast tier and the offload tier; residency there is earned
        # by the EMA pass below, never assigned fresh
        self._promote_set = (frozenset(n for n, _ in
                                       tier_budget.promote_tiers)
                             if tier_budget is not None else frozenset())
        self._chip = (tier_budget.tiers[0][0]
                      if tier_budget is not None and tier_budget.n_promote
                      else None)
        self._base = (tier_budget.base_tiers[0][0]
                      if tier_budget is not None else None)
        self.chiplet_device = chiplet_device
        self.ema_decay = ema_decay
        self.promote_threshold = promote_threshold
        self._ema: Dict[int, float] = {}      # page -> touch EMA
        self._ema_round: Dict[int, int] = {}  # page -> round of last bump
        self._round = 0                       # rebalance round counter
        self._lru: Dict[int, int] = {}        # page -> last-touch stamp
        self._stamp = 0
        self._ready_at: Dict[int, float] = {} # in-flight fetch completion
        self._fetch_pending: set = set()      # fetched, not yet waited on
        # dirty = content NOT mirrored at the offload tier: written since
        # allocation or since its last charged write-back. Spilling a
        # clean content page is a residency flip (the offload copy is
        # still valid) — only dirty content pays write-back bytes.
        self._dirty: set = set()
        # offload observability (engine folds these into ServeStats)
        self.spill_bytes = 0.0
        self.fetch_bytes = 0.0
        self.n_spills = 0
        self.n_fetches = 0
        self.prefetch_hits = 0
        self.prefetch_misses = 0
        self.clean_demotions = 0   # content spills that skipped write-back
        self.chiplet_promotions = 0
        self.chiplet_demotions = 0
        # per-direction DMA bytes keyed "src->dst" at each link boundary
        # (reconciled against the trace's per-label span bytes)
        self.channel_bytes: Dict[str, float] = {}
        # landed-page reads per residency tier at each kernel barrier —
        # the chiplet hit-rate numerator/denominator
        self.tier_touches: Dict[str, int] = {}
        self._free: List[int] = list(range(n_pages - 1, 0, -1))  # pop() -> 1
        self._seqs: Dict[int, _SeqAlloc] = {}
        self._ref: Dict[int, int] = {}                 # page -> refcount
        self._n_used = 0                               # O(1) distinct in-use
        # prefix cache: chain digest -> page; reverse map; per-parent
        # children (for partial-page matching); block token contents
        self._index: Dict[bytes, int] = {}
        self._page_key: Dict[int, bytes] = {}
        self._children: Dict[bytes, Dict[bytes, int]] = {}
        self._parent_key: Dict[bytes, bytes] = {}      # O(1) unregister
        self._block_tokens: Dict[bytes, Tuple[int, ...]] = {}
        self._evictable: "OrderedDict[int, None]" = OrderedDict()  # LRU
        # device copies the engine must apply before the next KV write
        self._pending_copies: List[Tuple[int, int]] = []
        # observability (reset by the engine per serve)
        self.dedup_hits = 0        # pages reused instead of recomputed
        self.dedup_tokens = 0      # prompt tokens whose prefill was skipped
        self.cow_copies = 0
        self.evictions = 0

    # ------------------------------ queries ---------------------------- #
    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_evictable(self) -> int:
        return len(self._evictable)

    @property
    def n_allocatable(self) -> int:
        """Pages an allocation may claim: free + evictable cached pages."""
        return len(self._free) + len(self._evictable)

    @property
    def n_used(self) -> int:
        """Distinct pages referenced by >=1 sequence. O(1) (maintained
        counter — this runs inside the per-step ``kv_tier_split`` path)."""
        return self._n_used

    def pages_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def can_admit(self, n_tokens: int, headroom_pages: int = 0) -> bool:
        return (self.pages_needed(n_tokens) + headroom_pages
                <= self.n_allocatable)

    def fits_at_all(self, n_tokens: int) -> bool:
        """Could the request EVER run, with the whole pool to itself?"""
        return self.pages_needed(n_tokens) <= self.n_pages - 1

    def seq_len(self, seq_id: int) -> int:
        return self._seqs[seq_id].n_tokens

    def seq_pages(self, seq_id: int) -> List[int]:
        return list(self._seqs[seq_id].pages)

    def page_ref(self, page: int) -> int:
        return self._ref.get(page, 0)

    def is_cached(self, page: int) -> bool:
        return page in self._page_key

    # --------------------------- page lifecycle ------------------------ #
    def _take_page(self) -> int:
        """Claim a page: free list first, else evict the LRU cached page."""
        if self._free:
            return self._free.pop()
        if self._evictable:
            page, _ = self._evictable.popitem(last=False)
            self._unregister_page(page)
            self.evictions += 1
            # reused as a fresh page: its old residency is meaningless
            self._drop_residency(page)
            return page
        raise PageAllocationError("page pool exhausted")

    def _incref(self, page: int) -> None:
        if self._ref.get(page, 0) == 0:
            self._evictable.pop(page, None)   # revived from the cache
            self._n_used += 1
            if page not in self._tier:        # fresh claim: assign a tier
                self._assign_tier(page)
            else:                             # cache revival keeps its tier
                self._touch(page)
        self._ref[page] = self._ref.get(page, 0) + 1

    def _decref(self, page: int) -> None:
        r = self._ref[page] - 1
        if r < 0:
            raise AssertionError(f"page {page} double-freed")
        if r == 0:
            del self._ref[page]
            self._n_used -= 1
            if page in self._page_key:        # stays cached, evictable
                self._evictable[page] = None  # (keeps its tier residency)
                # cancel any in-flight fetch: the owner is gone, and a
                # stale pending entry would both shield the page from
                # spill forever and hand a later revival a phantom hit
                self._fetch_pending.discard(page)
                self._ready_at.pop(page, None)
            else:
                self._drop_residency(page)
                self._free.append(page)
        else:
            self._ref[page] = r

    def _unregister_page(self, page: int) -> None:
        """Eviction runs on the per-token allocation path — O(1)."""
        key = self._page_key.pop(page, None)
        if key is None:
            return
        self._index.pop(key, None)
        self._block_tokens.pop(key, None)
        parent = self._parent_key.pop(key)
        kids = self._children.get(parent)
        if kids is not None:
            kids.pop(key, None)
            if not kids:
                del self._children[parent]

    # --------------------------- tier residency ------------------------ #
    # Every assigned page lives in exactly one budget tier (DESIGN.md
    # SS13). New pages land in the fastest tier with room and overflow
    # into the offload (slowest) tier; the block-aligned rebalance below
    # swaps LRU-cold fast pages against the offload-resident pages a
    # scheduled sequence is about to attend over.

    def page_tier(self, page: int) -> Optional[str]:
        """Residency tier of an assigned page (None: free/untracked)."""
        return self._tier.get(page)

    def tier_occupancy_pages(self) -> Dict[str, int]:
        """Assigned pages per tier (referenced + cached-evictable)."""
        return dict(self._tier_used)

    @property
    def fast_pages_used(self) -> int:
        """Assigned pages resident in the non-offload tiers."""
        if self._offload is None:
            return sum(self._tier_used.values())
        return sum(n for t, n in self._tier_used.items()
                   if t != self._offload)

    def _touch(self, page: int) -> None:
        self._stamp += 1
        self._lru[page] = self._stamp

    def _drop_residency(self, page: int) -> None:
        tier = self._tier.pop(page, None)
        if tier is not None:
            self._tier_used[tier] -= 1
        self._lru.pop(page, None)
        self._ready_at.pop(page, None)
        self._fetch_pending.discard(page)
        self._dirty.discard(page)
        self._ema.pop(page, None)
        self._ema_round.pop(page, None)

    def _mark_dirty(self, pages) -> None:
        """Record that the given pages' content is (about to be) written
        and therefore no longer mirrored at the offload tier. Over-marking
        an empty page is harmless: write-back is only charged for victims
        that carry content AND are dirty."""
        self._dirty.update(pages)

    def _acct(self, src: Optional[str], dst: Optional[str],
              n_bytes: float) -> None:
        if src is None or dst is None or n_bytes <= 0:
            return
        key = make_label(src, dst)
        self.channel_bytes[key] = self.channel_bytes.get(key, 0.0) + n_bytes

    def _assign_tier(self, page: int) -> None:
        """Fastest BASE tier with budget room; overflow goes straight to
        the offload tier (no churn during bulk prefill allocation — the
        rebalance pass promotes what the kernels actually touch).
        Promotion-only levels are skipped — chiplet residency is earned
        by the EMA pass — except as a last resort when every base tier is
        full (the pool is clamped to total_pages, which includes the
        promote levels, so they must be able to absorb the tail)."""
        if self.tier_budget is None:
            return
        b = self.tier_budget
        for name, cap in b.tiers[b.n_promote:] + b.tiers[:b.n_promote]:
            if self._tier_used[name] < cap:
                self._tier[page] = name
                self._tier_used[name] += 1
                self._touch(page)
                return
        raise AssertionError(
            "page pool exceeds the tier budget (pool is clamped to "
            "total_pages + 1 at construction)")

    def _spill_victims(self, pinned: set) -> List[int]:
        """LRU-cold spill candidates, coldest first: BASE-fast-resident
        pages that are neither pinned by the sequences being prepared nor
        have a fetch in flight (demoting a page mid-migration would let
        its owner consume a stale hit and attend over it for free).
        Promotion-level residents are not spill capacity — they leave the
        chiplet only via LRU demotion back to the base tier. One sorted
        pass per rebalance, popped in order, instead of a full scan per
        needed page."""
        return [p for _, p in sorted(
            (self._lru.get(p, 0), p) for p, tier in self._tier.items()
            if tier != self._offload and tier not in self._promote_set
            and p not in pinned and p not in self._fetch_pending)]

    def _promote_pass(self, hot_candidates: set, now: float) -> None:
        """EMA hot-page promotion into the chiplet level (DESIGN.md SS17).

        Every rebalance round bumps a per-page touch EMA for the pinned
        LANDED pages (``ema = ema * decay^rounds_since + 1``); a
        base-tier-resident page whose EMA crosses the threshold — touched
        on consecutive rounds — is promoted into the chiplet, demoting
        the chiplet's LRU-cold unpinned resident back to the base tier
        when it is full (the swap keeps per-tier counts). Migrations are
        charged on the dedicated chiplet link ("in" promote / "out"
        demote) but never gate a kernel: the page stays readable in its
        source tier while the copy streams, so the charge is link
        occupancy and trace visibility, not stall."""
        if self._chip is None or not hot_candidates:
            return
        self._round += 1
        rnd = self._round
        chip = self._chip
        cap = dict(self.tier_budget.tiers)[chip]
        decay = self.ema_decay
        hot: List[Tuple[float, int]] = []
        for p in hot_candidates:
            last = self._ema_round.get(p, rnd)
            e = self._ema.get(p, 0.0) * (decay ** (rnd - last)) + 1.0
            self._ema[p] = e
            self._ema_round[p] = rnd
            tier = self._tier.get(p)
            if (e >= self.promote_threshold and tier is not None
                    and tier != chip and tier != self._offload):
                hot.append((e, p))
        if not hot:
            return
        hot.sort(reverse=True)
        cold = [p for _, p in sorted(
            (self._lru.get(p, 0), p) for p, t in self._tier.items()
            if t == chip and p not in hot_candidates
            and p not in self._fetch_pending)]
        ci = 0
        n_promoted = 0
        n_demoted = 0
        for _, p in hot:
            src = self._tier[p]
            if self._tier_used[chip] < cap:
                self._tier[p] = chip
                self._tier_used[src] -= 1
                self._tier_used[chip] += 1
            elif ci < len(cold):
                victim = cold[ci]
                ci += 1
                self._tier[victim] = src     # swap keeps per-tier counts
                self._tier[p] = chip
                n_demoted += 1
            else:
                break                        # chiplet full of hot pages
            n_promoted += 1
        pb = self.page_nbytes
        base = self._base
        if n_promoted:
            self.chiplet_promotions += n_promoted
            self._acct(base, chip, n_promoted * pb)
            if self.chiplet_device is not None:
                self.chiplet_device.transfer("in", n_promoted * pb, now,
                                             label=make_label(base, chip))
        if n_demoted:
            self.chiplet_demotions += n_demoted
            self._acct(chip, base, n_demoted * pb)
            if self.chiplet_device is not None:
                self.chiplet_device.transfer("out", n_demoted * pb, now,
                                             label=make_label(chip, base))

    def plan_residency(self, seq_ids: Sequence[int], now: float
                       ) -> ResidencyPlan:
        """Rebalance tiers for the given sequences' pages and charge the
        out-channel traffic, WITHOUT issuing the demand fetch: each
        offload-resident LANDED page swaps tiers with an LRU-cold
        unpinned base-fast page, and becomes a fetch the returned plan
        carries for ``charge_residency`` to issue. Traffic follows
        content, not capacity: reserved-but-unwritten pages (lookahead
        windows, un-prefilled tails) hold no KV, so they are pinned
        against spill and promoted for free when room remains, but never
        charge fetch bytes — mirroring the ``kv_tier_split`` landed-pages
        rule. A spill victim is only charged if it carries content
        (landed or cached-evictable) AND is dirty — a clean victim's
        offload copy is still valid, so its demotion is a free residency
        flip (``clean_demotions``). Pages that cannot fit — the pinned
        working set itself exceeds the fast budget — stay
        offload-resident and are *streamed*: the read is charged per
        block. Ends with the EMA chiplet promotion pass."""
        seq_ids = tuple(seq_ids)
        if self.tier_budget is None:
            return ResidencyPlan(seq_ids, [], now)
        landed = self._landed_pages()
        pinned: set = set()
        need: List[int] = []                 # content-bearing: charged
        empty: List[int] = []                # write targets: free promote
        for sid in seq_ids:
            for p in self._seqs[sid].pages:
                if p in pinned:
                    continue
                pinned.add(p)
                if self._offload is None:
                    continue
                if self._tier.get(p) != self._offload:
                    continue
                # skip pages whose fetch is already in flight (or landed
                # but not yet consumed by a wait) — re-issuing would
                # double-charge a streamed page per block
                if p in self._fetch_pending:
                    continue
                (need if p in landed else empty).append(p)
        ready = now
        for p in pinned:
            t = self._ready_at.get(p)
            if t is not None and t > ready:
                ready = t                    # prefetch still in flight
        if need or empty:
            victims = self._spill_victims(pinned)
            # evictable cached pages hold real KV too — spilling them costs
            content = landed | set(self._evictable)
            vi = 0
            n_spilled = 0
            n_clean = 0
            for p in need + empty:           # recurring reads fill first
                if vi >= len(victims):
                    break                    # fast full of pinned: stream
                victim = victims[vi]
                vi += 1
                fast_tier = self._tier[victim]
                self._tier[victim] = self._offload
                self._tier[p] = fast_tier    # swap keeps per-tier counts
                if victim in content:
                    if victim in self._dirty:
                        n_spilled += 1       # write-back: content diverged
                        self._dirty.discard(victim)
                    else:
                        n_clean += 1         # offload copy still valid
            for p in pinned:                 # touch AFTER victim selection
                self._touch(p)
            pb = self.page_nbytes
            if self.tier_device is not None and n_spilled:
                self.tier_device.transfer(
                    "out", n_spilled * pb, now,
                    label=make_label(self._base, self._offload))
            self.n_spills += n_spilled
            self.spill_bytes += n_spilled * pb
            self.clean_demotions += n_clean
            self._acct(self._base, self._offload, n_spilled * pb)
        self._promote_pass(pinned & landed, now)
        return ResidencyPlan(seq_ids, need, ready)

    def _issue_fetch(self, plan: ResidencyPlan, now: float,
                     n_slices: int = 1) -> List[float]:
        """Charge the plan's demand fetch on the in-channel — one bulk
        batch, or one chained descriptor of ``n_slices`` layer slices —
        and mark the pages in flight. Returns per-slice completion times
        (empty when the plan carries no fetch)."""
        need = plan.need
        if not need:
            return []
        pb = self.page_nbytes
        self.n_fetches += len(need)
        self.fetch_bytes += len(need) * pb
        self._acct(self._offload, self._base, len(need) * pb)
        label = make_label(self._offload, self._base)
        if self.tier_device is None:
            dones = [now]
        elif n_slices > 1:
            dones = self.tier_device.transfer_sliced(
                "in", len(need) * pb, now, n_slices, label=label)
        else:
            dones = [self.tier_device.transfer(
                "in", len(need) * pb, now, label=label)]
        for p in need:
            self._ready_at[p] = dones[-1]
            self._fetch_pending.add(p)
        return dones

    def _ensure_fast(self, seq_ids: Sequence[int], now: float
                     ) -> Tuple[float, int]:
        """Plan + bulk fetch in one step (the whole-block barrier shape):
        returns ``(ready_time, n_pages_fetched)``; ``ready_time`` also
        covers still-in-flight fetches issued by an earlier prefetch."""
        plan = self.plan_residency(seq_ids, now)
        dones = self._issue_fetch(plan, now)
        done = dones[-1] if dones else now
        return max(plan.inflight_ready, done), len(plan.need)

    def charge_residency(self, plan: ResidencyPlan, now: float, *,
                         n_slices: int = 1, compute_s: float = 0.0,
                         per_seq: Optional[Dict[int, float]] = None
                         ) -> Tuple[float, float]:
        """Post-kernel half of the fetch-wait barrier: issue the plan's
        demand fetch and return ``(stall, barrier_stall)``.

        With ``n_slices > 1`` and a measured ``compute_s`` the fetch is a
        chained descriptor of layer slices pipelined against the layer
        loop (SS17): layer ``l`` computes as soon as its slice has landed
        and the previous layer is done, so the stall is only the
        un-hidden remainder ``max(0, pipeline_end - (now + compute_s))``.
        ``barrier_stall`` is the whole-block counterfactual (what
        ``n_slices=1`` would have stalled) — never smaller, reported so
        the engine can attribute the savings. Consumes the prefetch
        hit/miss accounting and counts per-tier landed-page touches (the
        chiplet hit rate).

        ``per_seq`` (optional out-param) receives each sequence's OWN
        stall — its barrier wait scaled by the block's actual-to-barrier
        stall ratio, so per-request attribution still sums to the block's
        recorded stall under overlap (SS13 per-request accounting)."""
        dones = self._issue_fetch(
            plan, now, n_slices=n_slices if compute_s > 0 else 1)
        base_ready = max(plan.inflight_ready, now)
        bulk = dones[-1] if dones else now
        barrier_stall = max(0.0, max(base_ready, bulk) - now)
        if len(dones) > 1:
            c = compute_s / len(dones)
            t = now
            for d in dones:
                # layer l starts when its slice landed (inflight bulk
                # transfers from an earlier prefetch gate every layer)
                t = max(t, d, base_ready) + c
            stall = max(0.0, t - (now + compute_s))
        else:
            stall = barrier_stall
        if per_seq is not None:
            scale = (stall / barrier_stall) if barrier_stall > 1e-12 else 0.0
            for sid in plan.seq_ids:
                own = now
                for p in self._seqs[sid].pages:
                    t = self._ready_at.get(p)
                    if t is not None and t > own:
                        own = t
                per_seq[sid] = (per_seq.get(sid, 0.0)
                                + max(0.0, own - now) * scale)
        for sid in plan.seq_ids:
            s = self._seqs[sid]
            for p in s.pages[:self.pages_needed(s.n_written)]:
                tier = self._tier.get(p)
                if tier is not None:
                    self.tier_touches[tier] = (
                        self.tier_touches.get(tier, 0) + 1)
            for p in s.pages:
                if p not in self._fetch_pending:
                    continue
                self._fetch_pending.discard(p)
                hit = self._ready_at.get(p, now) <= now
                if hit:
                    self.prefetch_hits += 1
                    self._ready_at.pop(p, None)
                else:
                    self.prefetch_misses += 1
                if self.tracer is not None:
                    self.tracer.prefetch(p, hit, now)
        return stall, barrier_stall

    def prefetch_seqs(self, seq_ids: Sequence[int], now: float,
                      lookahead_seqs: Sequence[int] = ()) -> float:
        """Block-aligned prefetch, issued *ahead* of the fused decode loop:
        start migrating every page the given sequences attend over toward
        the fast tiers, without waiting. ``now`` may be backdated to the
        previous kernel's launch time so the transfer overlaps compute.
        Returns the virtual completion time.

        ``lookahead_seqs``: queue-aware prefetch beyond the next block.
        When the fetch channel is otherwise idle at ``now`` — the primary
        prefetch issued nothing and nothing earlier is still in flight —
        the deepest (most landed KV) scheduled sequence gets its pages
        promoted too, backdated to ``now``: typically the next prefill
        chunk's cached-prefix pages, migrating during the decode block
        that would otherwise leave the channel dark (ROADMAP item 5)."""
        ready, n_fetched = self._ensure_fast(seq_ids, now)
        if (lookahead_seqs and self.tier_device is not None
                and n_fetched == 0
                and self.tier_device.idle("in", now)):
            deepest = max(lookahead_seqs,
                          key=lambda s: self._seqs[s].n_written)
            self._ensure_fast([deepest], now)
        return ready

    def residency_stall(self, seq_ids: Sequence[int], now: float, *,
                        per_seq: Optional[Dict[int, float]] = None) -> float:
        """Fetch-wait barrier before a kernel launch: demand-fetches any
        page still offload-resident (a prefetch miss) and returns the
        stall the kernel must absorb until every page's migration
        completes. The whole-block-barrier composition of
        ``plan_residency`` + ``charge_residency`` — the engine's
        ``--no-layer-overlap`` baseline and the direct-manager API."""
        plan = self.plan_residency(seq_ids, now)
        stall, _ = self.charge_residency(plan, now, per_seq=per_seq)
        return stall

    # ---------------------------- allocation --------------------------- #
    def allocate(self, seq_id: int, n_tokens: int, *,
                 reserve_tokens: Optional[int] = None) -> List[int]:
        """Claim fresh pages for a prefill. Pages are sized for
        ``reserve_tokens`` (e.g. the page-aligned padded prompt) while
        ``n_tokens`` records the real sequence length. Raises on
        exhaustion."""
        if seq_id in self._seqs:
            raise ValueError(f"sequence {seq_id} already allocated")
        need = self.pages_needed(max(reserve_tokens or 0, n_tokens))
        if need > self.n_allocatable:
            raise PageAllocationError(
                f"need {need} pages for seq {seq_id}, "
                f"only {self.n_allocatable} allocatable")
        pages = []
        for _ in range(need):
            p = self._take_page()
            self._incref(p)
            pages.append(p)
        self._seqs[seq_id] = _SeqAlloc(pages=pages, n_tokens=n_tokens,
                                       n_written=n_tokens)
        self._mark_dirty(pages)      # fresh KV: nothing mirrored offload
        return list(pages)

    def allocate_shared(self, seq_id: int, tokens: Sequence[int], *,
                        reserve_tokens: Optional[int] = None
                        ) -> PrefixAllocation:
        """Prefix-aware allocation: reuse cached pages for the longest
        indexed prefix of ``tokens`` (full pages shared by reference,
        a partially-matching page copy-on-write), fresh pages for the rest.

        ``n_cached`` is capped at ``len(tokens) - 1`` so at least the last
        token is always recomputed (its logits seed generation). Raises on
        exhaustion with nothing claimed."""
        if seq_id in self._seqs:
            raise ValueError(f"sequence {seq_id} already allocated")
        ps = self.page_size
        n_tokens = len(tokens)
        if not self.enable_prefix_cache:
            pages = self.allocate(seq_id, n_tokens,
                                  reserve_tokens=reserve_tokens)
            return PrefixAllocation(tuple(pages), 0)

        # walk the chain over full blocks (cap: keep >=1 token to compute)
        shared: List[int] = []
        parent = b""
        for b in range((n_tokens - 1) // ps):
            key = _chain_digest(parent, tokens[b * ps:(b + 1) * ps])
            page = self._index.get(key)
            if page is None:
                break
            shared.append(page)
            parent = key
        n_cached = len(shared) * ps

        # partial-page match: a cached child block sharing a strict prefix
        # of the request's next block -> copy-on-write a private page
        # (a full-block match is impossible here — the chain walk above
        # would have taken it)
        cow_src: Optional[int] = None
        partial = 0
        rest = tuple(tokens[n_cached:n_cached + ps])
        for key in self._children.get(parent, {}):
            blk = self._block_tokens.get(key, ())
            t = 0
            for a, c in zip(blk, rest):
                if a != c:
                    break
                t += 1
            t = min(t, n_tokens - 1 - n_cached)
            if t > partial:
                cow_src, partial = self._index[key], t
        if partial <= 0:
            cow_src = None

        need_total = self.pages_needed(max(reserve_tokens or 0, n_tokens))

        # atomic claim: check capacity up front (reviving an evictable
        # shared page shrinks the allocatable set without a _take_page)
        need_fresh = need_total - len(shared)   # incl. the COW copy, if any
        revived = sum(1 for p in shared if p in self._evictable)
        if need_fresh + revived > self.n_allocatable:
            raise PageAllocationError(
                f"need {need_fresh} pages for seq {seq_id}, only "
                f"{self.n_allocatable - revived} allocatable")
        for p in shared:
            self._incref(p)
        pages = list(shared)
        if cow_src is not None:
            dst = self._take_page()
            self._incref(dst)
            self._pending_copies.append((cow_src, dst))
            self.cow_copies += 1
            pages.append(dst)
            need_fresh -= 1
        for _ in range(need_fresh):
            p = self._take_page()
            self._incref(p)
            pages.append(p)
        self._seqs[seq_id] = _SeqAlloc(pages=pages, n_tokens=n_tokens,
                                       n_written=n_tokens)
        # fresh + COW pages will be written; reused shared pages keep
        # whatever dirty state their history earned
        self._mark_dirty(pages[len(shared):])
        self.dedup_hits += len(shared)
        self.dedup_tokens += n_cached + partial
        return PrefixAllocation(tuple(pages), n_cached + partial)

    def ensure_writable(self, seq_id: int, pos: int
                        ) -> Optional[Tuple[int, int]]:
        """Make the page covering token ``pos`` privately writable.

        Shared pages (refcount > 1) are copied-on-write: a fresh page is
        claimed, the (src, dst) device copy is queued, and the sequence's
        table is rewritten. A cached-but-exclusive page is unregistered
        instead (writing would silently diverge it from its content hash).
        Returns the (src, dst) pair when a copy was made, else None."""
        s = self._seqs[seq_id]
        idx = pos // self.page_size
        page = s.pages[idx]
        if self._ref.get(page, 0) > 1:
            dst = self._take_page()
            self._incref(dst)
            self._decref(page)
            s.pages[idx] = dst
            self._pending_copies.append((page, dst))
            self.cow_copies += 1
            self._mark_dirty((dst,))
            return (page, dst)
        if page in self._page_key:
            self._unregister_page(page)
        self._mark_dirty((page,))    # about to be written in place
        return None

    # ------------------------ lookahead reservation --------------------- #
    def reserve_ahead(self, seq_id: int, k: int) -> List[int]:
        """All-or-nothing reservation for the next ``k`` token writes
        (DESIGN.md SS12): after this returns, positions ``[n_tokens,
        n_tokens + k)`` are page-backed and privately writable, so a fused
        K-step decode can scatter KV without host intervention. Claims
        fresh pages past the sequence's current extent, copies-on-write any
        shared page inside the write window (the copies land in
        ``drain_copies``), and unregisters exclusively-owned cached pages
        there (their content is about to diverge from their hash).

        Does NOT advance ``n_tokens`` — the host commits the block's actual
        write count afterwards (``commit_tokens``); a preempted or retired
        sequence releases everything via ``free_seq``. Raises on exhaustion
        with nothing claimed (the scheduler preempts and retries). Returns
        the newly claimed page ids (fresh + COW copies)."""
        s = self._seqs[seq_id]
        if k <= 0:
            return []
        ps = self.page_size
        need_total = self.pages_needed(s.n_tokens + k)
        first = s.n_tokens // ps
        window_have = range(first, min(len(s.pages), need_total))
        cow_idx = [i for i in window_have
                   if self._ref.get(s.pages[i], 0) > 1]
        n_fresh = max(need_total - len(s.pages), 0)
        if n_fresh + len(cow_idx) > self.n_allocatable:
            raise PageAllocationError(
                f"lookahead({k}) for seq {seq_id} needs "
                f"{n_fresh + len(cow_idx)} pages, only "
                f"{self.n_allocatable} allocatable")
        claimed: List[int] = []
        for i in cow_idx:
            src = s.pages[i]
            dst = self._take_page()
            self._incref(dst)
            self._decref(src)
            s.pages[i] = dst
            self._pending_copies.append((src, dst))
            self.cow_copies += 1
            claimed.append(dst)
        for i in window_have:         # now-private pages must leave the index
            if s.pages[i] in self._page_key:
                self._unregister_page(s.pages[i])
        for _ in range(n_fresh):
            p = self._take_page()
            self._incref(p)
            s.pages.append(p)
            claimed.append(p)
        # every page in the write window is about to diverge from any
        # offload mirror it had
        self._mark_dirty(s.pages[i] for i in window_have)
        self._mark_dirty(claimed)
        return claimed

    def commit_tokens(self, seq_id: int, n: int) -> None:
        """Advance the landed-KV length by ``n`` after a fused decode block
        wrote ``n`` tokens into previously reserved pages."""
        s = self._seqs[seq_id]
        if self.pages_needed(s.n_tokens + n) > len(s.pages):
            raise ValueError(
                f"commit of {n} tokens for seq {seq_id} exceeds its "
                f"reserved pages (reserve_ahead first)")
        lo = s.n_tokens // self.page_size
        s.n_tokens += n
        s.n_written = s.n_tokens
        self._mark_dirty(s.pages[lo:self.pages_needed(s.n_tokens)])

    def commit_speculative(self, seq_id: int, n_accepted: int) -> int:
        """Partial rollback after a speculative verify pass (DESIGN.md
        SS14): the pass reserved ``draft_len + 1`` positions and wrote KV
        for every fed token, but only ``n_accepted`` of them (accepted
        draft prefix + the corrected/bonus token) survive. Commit those
        and return every reserved page past the new landed extent to the
        pool — the rejected suffix's KV stays as garbage inside still-
        owned pages (overwritten by the next pass before any read) or on
        released pages (reclaimable immediately).

        Returns the number of pages rolled back. Equivalent to
        ``commit_tokens(n_accepted)`` + ``release_reserved()``; a single
        entry point so the invariant "landed extent == emitted tokens"
        cannot be split across a preemption window."""
        self.commit_tokens(seq_id, n_accepted)
        return self.release_reserved(seq_id)

    def mark_written(self, seq_id: int, n: int) -> None:
        """Set the landed-KV extent to ``n`` tokens (clamped to the
        tracked length). The chunked-prefill scheduler resets this to the
        cached-prefix length at admission and advances it per chunk, so
        pages the prefill has not reached yet are priced as capacity, not
        attention/migration traffic (the ``_landed_pages`` rule)."""
        s = self._seqs[seq_id]
        lo = s.n_written // self.page_size
        s.n_written = max(0, min(n, s.n_tokens))
        if s.n_written > lo * self.page_size:
            self._mark_dirty(s.pages[lo:self.pages_needed(s.n_written)])

    def release_reserved(self, seq_id: int) -> int:
        """Return reserved-but-unwritten pages (past the landed extent) to
        the pool; the inverse of ``reserve_ahead`` for a sequence that
        stays resident. Preemption/retirement need no explicit release —
        ``free_seq`` drops reserved pages with the rest."""
        s = self._seqs[seq_id]
        keep = self.pages_needed(s.n_tokens)
        n = 0
        while len(s.pages) > keep:
            self._decref(s.pages.pop())
            n += 1
        return n

    def append_token(self, seq_id: int) -> Optional[int]:
        """Extend a sequence by one token; returns the newly claimed page id
        when a page boundary is crossed, else None. Writes into a shared
        page trigger copy-on-write (the copy lands in ``drain_copies``).
        Raises on exhaustion (the scheduler preempts and retries)."""
        s = self._seqs[seq_id]
        new_page = None
        if self.pages_needed(s.n_tokens + 1) > len(s.pages):
            new_page = self._take_page()
            self._incref(new_page)
            s.pages.append(new_page)
            self._mark_dirty((new_page,))
        else:
            self.ensure_writable(seq_id, s.n_tokens)  # marks dirty
        s.n_tokens += 1
        s.n_written = s.n_tokens
        return new_page

    def free_seq(self, seq_id: int) -> int:
        """Drop a retired/preempted sequence's references. Cached pages
        whose refcount hits zero become evictable; the rest return to the
        free list. Pages are released deepest-first so LRU eviction
        reclaims the END of a cached chain before its head — a chain is
        only matchable through its prefix, so head pages are the valuable
        ones."""
        s = self._seqs.pop(seq_id)
        if self._pending_copies:
            # purge queued COW copies targeting this sequence's pages: the
            # dst was private to it, and once released it may be re-claimed
            # and re-targeted before the engine drains — duplicate dst
            # entries in one copy_pages batch scatter in undefined order
            released = set(s.pages)
            self._pending_copies = [(src, dst) for src, dst
                                    in self._pending_copies
                                    if dst not in released]
        for p in reversed(s.pages):
            self._decref(p)
        return len(s.pages)

    def drain_copies(self) -> List[Tuple[int, int]]:
        """(src, dst) page copies queued by COW since the last drain. The
        engine must apply them to the device pool before the next write."""
        out, self._pending_copies = self._pending_copies, []
        return out

    # --------------------------- prefix cache -------------------------- #
    def register_prefix(self, seq_id: int, tokens: Sequence[int],
                        n_valid: Optional[int] = None) -> int:
        """Index the sequence's full pages under their chained block hashes
        so later prompts can reuse them. ``n_valid`` caps how many leading
        tokens actually hold valid KV (defaults to the tracked length).
        Returns the number of newly indexed pages."""
        if not self.enable_prefix_cache:
            return 0
        s = self._seqs[seq_id]
        limit = min(len(tokens), s.n_tokens,
                    n_valid if n_valid is not None else s.n_tokens)
        ps = self.page_size
        parent = b""
        added = 0
        for b in range(limit // ps):
            block = tuple(tokens[b * ps:(b + 1) * ps])
            key = _chain_digest(parent, block)
            if key not in self._index:
                page = s.pages[b]
                if page in self._page_key:
                    # page already indexed under another chain (e.g. the
                    # request itself reused it) — leave that entry alone
                    parent = key
                    continue
                self._index[key] = page
                self._page_key[page] = key
                self._children.setdefault(parent, {})[key] = page
                self._parent_key[key] = parent
                self._block_tokens[key] = block
                added += 1
            parent = key
        return added

    def lookup_prefix(self, tokens: Sequence[int]) -> int:
        """Tokens of ``tokens`` a prefix-aware allocation would reuse
        (full-page matches only; does not claim anything)."""
        if not self.enable_prefix_cache:
            return 0
        ps = self.page_size
        parent = b""
        n = 0
        for b in range(min(len(tokens) // ps, (len(tokens) - 1) // ps)):
            key = _chain_digest(parent, tokens[b * ps:(b + 1) * ps])
            if key not in self._index:
                break
            n += ps
            parent = key
        return n

    # --------------------------- table export -------------------------- #
    def table_row(self, seq_id: int, n_pages_per_seq: int) -> np.ndarray:
        """Padded int32 page-table row (null page 0 past the last page)."""
        pages = self._seqs[seq_id].pages
        row = np.zeros((n_pages_per_seq,), np.int32)
        row[:len(pages)] = pages
        return row

    # --------------------------- tier feedback ------------------------- #
    def _landed_pages(self) -> set:
        """Pages holding written KV a kernel would read: each sequence's
        pages up to its written extent. Reserved-but-unwritten lookahead
        pages (``reserve_ahead``) and prompt pages the chunked prefill has
        not reached yet (``mark_written``) are excluded — they occupy
        capacity but carry no attention traffic, so pricing them would
        overstate the traffic mass. Shared pages count once."""
        landed: set = set()
        for s in self._seqs.values():
            landed.update(s.pages[:self.pages_needed(s.n_written)])
        return landed

    def kv_tier_split(self) -> Tuple[Tuple[str, float], ...]:
        """Landed pages as a tier split, by REAL per-page residency.

        Matches the ``Placement.splits`` shape so the analytical model can
        price attention traffic with the tier placement the runtime pool
        actually produced (spills, prefetches and all) — not an analytic
        fast-tier-first fill. Shared pages count once — prefix dedup
        shrinks the split's mass; reserved lookahead pages are capacity,
        not traffic, and are excluded."""
        if self.tier_budget is None:
            raise ValueError(
                "kv_tier_split() needs tier information: construct the "
                "manager with tier_budget=TierBudget.from_hierarchy(...)")
        landed = self._landed_pages()
        if not landed:
            return ()
        counts: Dict[str, int] = {}
        for p in landed:
            tier = self._tier.get(p)
            if tier is not None:
                counts[tier] = counts.get(tier, 0) + 1
        total = len(landed)
        return tuple((name, counts[name] / total)
                     for name, _ in self.tier_budget.tiers
                     if counts.get(name))

    def tier_occupancy_bytes(self, cfg: Optional[ArchConfig] = None,
                             dtype_bytes: Optional[int] = None
                             ) -> Dict[str, float]:
        """Landed-KV bytes per tier, priced at the ACTIVE cache width
        (``self.dtype_bytes``, e.g. 1 for an int8 cache) unless the caller
        overrides — an int8 pool must not be priced at bf16 widths."""
        if self.page_nbytes and dtype_bytes is None:
            pb = self.page_nbytes
        else:
            if cfg is None:
                raise ValueError("pass cfg= (or construct the manager with "
                                 "page_nbytes=) to price occupancy")
            pb = page_bytes(cfg, self.page_size,
                            self.dtype_bytes if dtype_bytes is None
                            else dtype_bytes)
        n_landed = len(self._landed_pages())
        return {name: frac * n_landed * pb
                for name, frac in self.kv_tier_split()}
