"""Concurrency-aware analytical serving model (paper capacity pressure).

The paper observes that "even a low degree of concurrent inference serving
… can further add to memory capacity pressure": every in-flight request
adds a full KV cache, so the aggregate ``TC.KV`` footprint grows linearly
with concurrency while the hierarchy's fast tiers do not. This module asks
the roofline engine the resulting question for ANY hierarchy preset: how
does TPS scale with the number of concurrent requests once the KV class
starts spilling to slower tiers?

It is the analytical twin of the runtime's paged KV pool: a
``PagedKVManager.kv_tier_split()`` can be passed in verbatim (``kv_split``)
to price attention traffic with the tier occupancy the runtime actually
produced, instead of the greedy capacity_aware split.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.configs.base import ArchConfig
from repro_torch.core.memspec import MemoryHierarchy
from repro_torch.core.placement import Placement, capacity_aware
from repro_torch.core.roofline import InferenceReport, run_inference
from repro_torch.core.workload import TC, resident_bytes


@dataclass(frozen=True)
class ConcurrencyPoint:
    """One point of the TPS-vs-concurrency curve."""
    n_concurrent: int
    report: InferenceReport
    kv_bytes: float                              # aggregate KV footprint
    kv_locations: Tuple[Tuple[str, float], ...]  # where the KV ended up
    kv_preferred: str                            # the policy's KV tier

    @property
    def aggregate_tps(self) -> float:
        return self.report.tps

    @property
    def per_request_tps(self) -> float:
        return self.report.tps / self.n_concurrent

    @property
    def kv_spill_frac(self) -> float:
        """Fraction of the KV class NOT on its preferred tier."""
        on_pref = sum(frac for level, frac in self.kv_locations
                      if level == self.kv_preferred)
        return 1.0 - on_pref

    @property
    def bottleneck(self) -> str:
        return self.report.bottleneck


def kv_dedup_factor(n_concurrent: int, prefill_len: int, decode_len: int, *,
                    shared_prefix_len: int = 0,
                    share_group: int = 1) -> float:
    """Unique / naive aggregate KV under prefix sharing.

    The runtime's shared-prefix page reuse (serving.kv_manager) stores the
    KV of a document prefix ONCE per document instead of once per request.
    With ``n_concurrent`` requests in groups of ``share_group`` over the
    same document (``shared_prefix_len`` tokens of the prompt), the unique
    footprint is ``n*(ctx - p) + ceil(n/g)*p`` tokens against the naive
    ``n*ctx`` — the factor the analytical sweep scales ``TC.KV`` by."""
    ctx = prefill_len + decode_len
    g = max(share_group, 1)
    p = min(max(shared_prefix_len, 0), prefill_len)
    if g <= 1 or p <= 0 or n_concurrent <= 0:
        return 1.0
    n = n_concurrent
    n_docs = -(-n // g)
    return (n * (ctx - p) + n_docs * p) / (n * ctx)


def placement_with_kv_split(place: Placement,
                            kv_split: Sequence[Tuple[str, float]]
                            ) -> Placement:
    """Pin the KV class to an explicit tier split (e.g. the runtime paged
    pool's ``kv_tier_split()``) instead of the policy's preferred tier."""
    splits = dict(place.splits)
    splits[TC.KV] = tuple(kv_split)
    return Placement(place.name + "+kvrt", dict(place.mapping), splits)


def concurrent_inference(cfg: ArchConfig, hier: MemoryHierarchy,
                         place: Placement, *, n_concurrent: int,
                         prefill_len: int, decode_len: int,
                         dtype_bytes: int = 2,
                         kv_split: Optional[Sequence[Tuple[str, float]]] = None,
                         shared_prefix_len: int = 0,
                         share_group: int = 1,
                         kv_shards: int = 1,
                         kv_dtype_bytes: Optional[int] = None
                         ) -> ConcurrencyPoint:
    """Serve ``n_concurrent`` simultaneous requests analytically.

    The aggregate KV footprint (``TC.KV`` scaled by batch) runs through
    ``capacity_aware`` spilling, so past the fast tier's capacity the
    marginal request pays slow-tier attention traffic — the capacity-
    pressure curve the runtime engine measures.

    ``shared_prefix_len``/``share_group`` model the runtime's prefix-page
    dedup: the aggregate KV is scaled by ``kv_dedup_factor`` before the
    capacity pass, so shared-document workloads spill later and fit more
    concurrency (the headroom the paged pool actually realizes).

    ``kv_shards`` is the per-device analytic view of head-sharded serving
    (DESIGN.md SS16): an N-way mesh leaves each device Hkv/N heads of
    every request's KV, so the per-chip ``TC.KV`` footprint — what this
    hierarchy's capacities constrain — divides by N while weights and
    activations replicate. The runtime twin is ``ServeEngine(shards=N)``,
    whose ``TierBudget`` divides page bytes the same way.

    A pinned ``kv_split`` bypasses the greedy KV split entirely: the KV
    class is removed from the capacity pass (its tier occupancy is instead
    pre-charged against each tier's capacity) and the runtime-observed
    split is applied on top.

    ``kv_dtype_bytes`` (runtime twin: ``ServeEngine(cache_dtype="int8")``)
    stores the KV class narrower than the compute dtype: the TC.KV
    footprint — what the capacity pass spills — scales by
    ``kv_dtype_bytes / dtype_bytes``, so a quantized cache fits more
    concurrency before tier spill. Traffic stays priced at the compute
    dtype here; the traffic-side scaling composes in
    ``min_hbs_bandwidth_for_itl(kv_traffic_scale=...)``."""
    if kv_shards < 1:
        raise ValueError(f"kv_shards ({kv_shards}) must be >= 1")
    ctx = prefill_len + decode_len
    fp = resident_bytes(cfg, ctx, n_concurrent, dtype_bytes)
    fp[TC.KV] = fp[TC.KV] * kv_dedup_factor(
        n_concurrent, prefill_len, decode_len,
        shared_prefix_len=shared_prefix_len,
        share_group=share_group) / kv_shards
    if kv_dtype_bytes is not None:
        if kv_dtype_bytes < 1:
            raise ValueError(f"kv_dtype_bytes ({kv_dtype_bytes}) must be >= 1")
        fp[TC.KV] = fp[TC.KV] * kv_dtype_bytes / dtype_bytes
    if kv_split is not None:
        # charge the pinned KV residency against the tiers it occupies so
        # co-resident classes see the reduced capacity, then keep the KV
        # class out of capacity_aware (which would re-split and overwrite)
        kv_bytes = fp[TC.KV]
        charged = hier
        for level, frac in kv_split:
            cap = hier.level(level).capacity
            if cap is not None:
                charged = charged.with_level(
                    level, capacity=max(cap - frac * kv_bytes, 0.0))
        fp_rest = {c: v for c, v in fp.items() if c != TC.KV}
        placed = capacity_aware(place, charged, fp_rest)
        placed = placement_with_kv_split(placed, kv_split)
    else:
        placed = capacity_aware(place, hier, fp)
    rep = run_inference(cfg, hier, placed, prefill_len, decode_len,
                        batch=n_concurrent, dtype_bytes=dtype_bytes,
                        capacity_check=False)
    return ConcurrencyPoint(n_concurrent, rep, fp[TC.KV],
                            placed.locations(TC.KV), place.mapping[TC.KV])


def concurrency_sweep(cfg: ArchConfig, hier: MemoryHierarchy,
                      place: Placement, *,
                      concurrency: Iterable[int] = (1, 2, 4, 8, 16),
                      prefill_len: int = 2048, decode_len: int = 256,
                      dtype_bytes: int = 2, shared_prefix_len: int = 0,
                      share_group: int = 1) -> List[ConcurrencyPoint]:
    """TPS-vs-concurrency curve (the paper's experiment, any hierarchy)."""
    return [concurrent_inference(cfg, hier, place, n_concurrent=n,
                                 prefill_len=prefill_len,
                                 decode_len=decode_len,
                                 dtype_bytes=dtype_bytes,
                                 shared_prefix_len=shared_prefix_len,
                                 share_group=share_group)
            for n in concurrency]


@dataclass(frozen=True)
class HBSGridPoint:
    """One cell of the HBS bandwidth x latency interactivity grid."""
    bw_gbps: float
    latency_us: float
    point: ConcurrencyPoint

    @property
    def tps(self) -> float:
        return self.point.aggregate_tps

    @property
    def itl_s(self) -> float:
        """Predicted per-request inter-token latency: all concurrent
        requests advance together, so decode wall time over the decode
        length is the seconds each request waits between its tokens."""
        rep = self.point.report
        return rep.decode_time / max(rep.decode_len, 1)

    @property
    def kv_spill_frac(self) -> float:
        return self.point.kv_spill_frac


def hbs_interactivity_sweep(cfg: ArchConfig, hier: MemoryHierarchy,
                            place: Placement, *,
                            bw_gbps: Iterable[float] = (2., 4., 8., 16., 32.),
                            latency_us: Iterable[float] = (5., 20., 80.),
                            n_concurrent: int = 1,
                            prefill_len: int = 8192, decode_len: int = 256,
                            dtype_bytes: int = 2,
                            kv_split: Optional[Sequence[Tuple[str, float]]]
                            = None) -> List[HBSGridPoint]:
    """The paper's HBS requirement table, analytically: TPS and predicted
    ITL over a bandwidth x latency grid for the ``"hbs"`` level of
    ``hier`` — the envelope HBS must hit for a long-context large-model
    workload to stay interactive once its KV spills past the fast tiers.

    The runtime twin is ``benchmarks/hbs_sweep.py``, which drives the
    serve engine's real page-residency offload over the same grid; a
    ``kv_split`` observed from ``PagedKVManager.kv_tier_split()`` (landed
    pages only — reserved lookahead pages carry no traffic) can be pinned
    here so both halves price the same placement."""
    hier.level("hbs")        # fail fast: with_level() would silently no-op
    out: List[HBSGridPoint] = []
    for bw in bw_gbps:
        for lat in latency_us:
            h = hier.with_level("hbs", bandwidth=bw * 1e9,
                                latency=lat * 1e-6)
            pt = concurrent_inference(cfg, h, place,
                                      n_concurrent=n_concurrent,
                                      prefill_len=prefill_len,
                                      decode_len=decode_len,
                                      dtype_bytes=dtype_bytes,
                                      kv_split=kv_split)
            out.append(HBSGridPoint(bw, lat, pt))
    return out


@dataclass(frozen=True)
class ChipletGridPoint:
    """One cell of the chiplet-capacity x HBS bandwidth/latency grid."""
    chiplet_mb: float
    hit_frac: float           # fraction of KV reads served by the chiplet
    base: HBSGridPoint

    @property
    def bw_gbps(self) -> float:
        return self.base.bw_gbps

    @property
    def latency_us(self) -> float:
        return self.base.latency_us

    @property
    def tps(self) -> float:
        return self.base.tps

    @property
    def itl_s(self) -> float:
        """HBS-bound approximation (DESIGN.md SS17): on a long-context
        decode the inter-token latency is dominated by streaming the KV
        off the offload link, so the fraction ``hit_frac`` of reads the
        bonded chiplet absorbs shrinks the ITL by ``1 - hit_frac``.
        Never worse than the chiplet-less base point by construction."""
        return self.base.itl_s * (1.0 - self.hit_frac)

    @property
    def kv_spill_frac(self) -> float:
        return self.base.kv_spill_frac


def chiplet_kv_hit_frac(cfg: ArchConfig, ctx: int, *, chiplet_mb: float,
                        dtype_bytes: int = 2) -> float:
    """Steady-state fraction of per-token KV reads served from a bonded
    chiplet buffer of ``chiplet_mb`` megabytes.

    Decode attention reads the whole landed context every token, so a
    capacity-``C`` buffer holding the hottest pages serves ``C / KV``
    of the read traffic once the EMA promoter has converged (the runtime
    twin is ``ServeStats.chiplet_hit_rate``). Clamped to [0, 1]; a buffer
    larger than the working set hits on every read."""
    if chiplet_mb <= 0:
        return 0.0
    kv = float(cfg.kv_bytes_per_token(dtype_bytes)) * max(ctx, 1)
    if kv <= 0:
        return 0.0
    return min(chiplet_mb * 1e6 / kv, 1.0)


def chiplet_interactivity_sweep(cfg: ArchConfig, hier: MemoryHierarchy,
                                place: Placement, *,
                                chiplet_mb: Iterable[float] = (32., 64., 128.),
                                bw_gbps: Iterable[float] = (2., 4., 8., 16.,
                                                            32.),
                                latency_us: Iterable[float] = (5., 20., 80.),
                                n_concurrent: int = 1,
                                prefill_len: int = 8192,
                                decode_len: int = 256,
                                dtype_bytes: int = 2,
                                kv_dtype_bytes: Optional[int] = None,
                                kv_split: Optional[Sequence[Tuple[str, float]]]
                                = None) -> List[ChipletGridPoint]:
    """The HBS interactivity grid with a chiplet global-buffer tier in
    front of it: every ``(chiplet capacity, HBS bandwidth, HBS latency)``
    cell reports the ITL after the chiplet's steady-state hit fraction
    absorbs its share of the KV streaming (DESIGN.md SS17).

    The base HBS grid is swept ONCE — the chiplet axis only rescales the
    readout — so the sweep costs the same roofline passes as
    ``hbs_interactivity_sweep``. The runtime twin is
    ``benchmarks/chiplet_sweep.py``, which drives the serve engine's EMA
    promoter over the same chiplet sizes. ``kv_dtype_bytes`` prices the
    hit fraction at the stored KV width: a narrower cache fits more
    context into the same chiplet, compounding the two levers."""
    grid = hbs_interactivity_sweep(cfg, hier, place, bw_gbps=bw_gbps,
                                   latency_us=latency_us,
                                   n_concurrent=n_concurrent,
                                   prefill_len=prefill_len,
                                   decode_len=decode_len,
                                   dtype_bytes=dtype_bytes,
                                   kv_split=kv_split)
    ctx = prefill_len + decode_len
    out: List[ChipletGridPoint] = []
    for mb in chiplet_mb:
        h = chiplet_kv_hit_frac(cfg, ctx, chiplet_mb=mb,
                                dtype_bytes=(kv_dtype_bytes
                                             if kv_dtype_bytes is not None
                                             else dtype_bytes))
        for g in grid:
            out.append(ChipletGridPoint(mb, h, g))
    return out


def expected_tokens_per_pass(alpha: float, k: int) -> float:
    """Expected tokens landed by ONE speculative verify pass with draft
    length ``k`` and per-position acceptance probability ``alpha``
    (DESIGN.md SS14).

    The accepted prefix is geometric — position j lands iff all of
    positions 0..j were accepted — and the correction/bonus token always
    lands, so E = sum_{j=0..k} alpha^j = (1 - alpha^(k+1)) / (1 - alpha),
    ranging from 1 (alpha=0: plain decode) to k+1 (alpha=1)."""
    if k < 0:
        raise ValueError("k must be >= 0")
    a = min(max(alpha, 0.0), 1.0)
    if a >= 1.0:
        return float(k + 1)
    return (1.0 - a ** (k + 1)) / (1.0 - a)


def speculative_tps(base_tps: float, alpha: float, k: int, *,
                    overhead_frac: float = 0.0) -> float:
    """Analytic decode TPS with speculative decoding layered on a plain
    decode rate of ``base_tps``.

    A verify pass streams weights + KV once — the same traffic a single
    decode step pays, which is what ``base_tps`` prices — and lands
    ``expected_tokens_per_pass(alpha, k)`` tokens. ``overhead_frac`` is
    the extra per-pass cost relative to one plain step (draft compute +
    the verify window's K extra query rows; ~0 for n-gram drafts on a
    bandwidth-bound platform)."""
    e = expected_tokens_per_pass(alpha, k)
    return base_tps * e / (1.0 + max(overhead_frac, 0.0))


def min_hbs_bandwidth_for_itl(grid: Sequence[HBSGridPoint],
                              itl_target_s: float, *,
                              tokens_per_pass: float = 1.0,
                              overhead_frac: float = 0.0,
                              kv_traffic_scale: float = 1.0,
                              chiplet_hit_frac: float = 0.0
                              ) -> Dict[float, float]:
    """Per HBS latency, the smallest swept bandwidth whose predicted ITL
    meets the target (the paper's requirement readout); latencies whose
    entire bandwidth sweep misses the target map to ``inf``.

    ``tokens_per_pass`` (> 1 with speculative decoding; see
    ``expected_tokens_per_pass``) divides the effective ITL: each
    bandwidth-bound streaming pass emits that many tokens on average, so
    the SAME interactivity target is met at LOWER HBS bandwidth — the
    spec-compounded envelope. ``overhead_frac`` prices the per-pass draft
    + verify-window overhead.

    ``kv_traffic_scale`` (int8 KV: ``kv_dtype_bytes / dtype_bytes``) and
    ``chiplet_hit_frac`` (see ``chiplet_kv_hit_frac``) shrink the
    KV-streaming portion of the ITL under the HBS-bound approximation
    (DESIGN.md SS17): a narrower stored cache moves fewer bytes per read,
    and chiplet-resident hot pages never touch the HBS link at all, so
    ``itl_eff = itl * kv_traffic_scale * (1 - chiplet_hit_frac)``. Both
    factors are <= 1, so the returned envelope is never-worse than the
    plain one by construction. Defaults reproduce plain fp16 decode.
    Pass ``chiplet_hit_frac`` only with a plain ``HBSGridPoint`` grid —
    a ``ChipletGridPoint`` grid already folds its own hit fraction into
    ``itl_s``."""
    if tokens_per_pass <= 0:
        raise ValueError("tokens_per_pass must be > 0")
    if not 0.0 < kv_traffic_scale <= 1.0:
        raise ValueError(f"kv_traffic_scale ({kv_traffic_scale}) must be "
                         "in (0, 1]")
    if not 0.0 <= chiplet_hit_frac <= 1.0:
        raise ValueError(f"chiplet_hit_frac ({chiplet_hit_frac}) must be "
                         "in [0, 1]")
    scale = ((1.0 + max(overhead_frac, 0.0)) / tokens_per_pass
             * kv_traffic_scale * (1.0 - chiplet_hit_frac))
    best: Dict[float, float] = {}
    for g in grid:
        if g.itl_s * scale <= itl_target_s:
            cur = best.get(g.latency_us, float("inf"))
            best[g.latency_us] = min(cur, g.bw_gbps)
        else:
            best.setdefault(g.latency_us, float("inf"))
    return best


def compounded_offload_envelope(grid: Sequence[HBSGridPoint],
                                itl_target_s: float, *,
                                dtype_bytes: int = 2,
                                kv_dtype_bytes: int = 1,
                                chiplet_hit_frac: float = 0.0,
                                tokens_per_pass: float = 1.0,
                                overhead_frac: float = 0.0
                                ) -> Dict[float, float]:
    """The int8-KV x chiplet x speculative compounded HBS requirement:
    every lever the stack implements, priced against ONE swept grid.

    Quantized KV (``kv_dtype_bytes`` < ``dtype_bytes``) scales the bytes
    each streamed token moves; the chiplet's hit fraction removes its
    share of reads from the HBS link entirely; speculative decoding lands
    ``tokens_per_pass`` tokens per streaming pass. All three multiply
    into the effective ITL, so the minimum HBS bandwidth that keeps the
    platform interactive drops by the product — the paper's "technology
    solutions compound" readout. With all defaults at their identity
    values this is exactly ``min_hbs_bandwidth_for_itl(grid, target)``."""
    if kv_dtype_bytes < 1 or dtype_bytes < 1:
        raise ValueError("dtype widths must be >= 1 byte")
    if kv_dtype_bytes > dtype_bytes:
        raise ValueError(f"kv_dtype_bytes ({kv_dtype_bytes}) must not "
                         f"exceed dtype_bytes ({dtype_bytes})")
    return min_hbs_bandwidth_for_itl(
        grid, itl_target_s, tokens_per_pass=tokens_per_pass,
        overhead_frac=overhead_frac,
        kv_traffic_scale=kv_dtype_bytes / dtype_bytes,
        chiplet_hit_frac=chiplet_hit_frac)


def max_concurrency_without_spill(cfg: ArchConfig, hier: MemoryHierarchy,
                                  place: Placement, *, prefill_len: int,
                                  decode_len: int, dtype_bytes: int = 2,
                                  limit: int = 4096,
                                  shared_prefix_len: int = 0,
                                  share_group: int = 1) -> int:
    """Largest concurrency whose aggregate (dedup'd) KV still fits its
    preferred tier (the runtime admission controller's analytical
    counterpart). Prefix sharing shrinks the marginal request's KV, so the
    no-spill limit GROWS with the share factor — the extra concurrency the
    paged pool fits before tier spill."""
    kv_level = place.mapping[TC.KV]
    cap = hier.level(kv_level).capacity
    if cap is None:
        return limit
    ctx = prefill_len + decode_len
    per_tok = float(cfg.kv_bytes_per_token(dtype_bytes))
    if per_tok <= 0:
        return limit
    # the preferred tier also houses whatever other classes map to it
    fp1 = resident_bytes(cfg, ctx, 1, dtype_bytes)
    other = sum(v for c, v in fp1.items()
                if c != TC.KV and place.mapping.get(c) == kv_level)
    avail = max(cap - other, 0.0)
    g = max(share_group, 1)
    p = min(max(shared_prefix_len, 0), prefill_len) if g > 1 else 0
    best = 0
    for n in range(1, limit + 1):
        unique_tokens = n * (ctx - p) + (-(-n // g)) * p
        if unique_tokens * per_tok > avail:
            break
        best = n
    return best
