"""Hierarchical, latency-aware roofline engine (paper Sec. II).

    time(kernel) = max( FLOPs / compute_throughput,
                        max over memory levels l of
                            traffic_l / bw_l  +  n_chunks_l * latency_l )

Traffic per level comes from the analytic tiling search (``tiling.py``):
an operand resident at level P crosses every boundary from P inward; at each
boundary its re-read factor is set by the traffic-minimising tiling that fits
the boundary's staging capacity.  Transfers are issued at the granularity of
the consuming (L2-resident) tile — or the operand's natural unit (e.g. one
head's K matrix) if smaller — and each issue pays the level's latency
(non-overlapped; the paper's NAND-class HBS has no deep request queue).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from repro_torch.configs.base import ArchConfig
from repro_torch.core.memspec import MemoryHierarchy
from repro_torch.core.placement import Placement, capacity_aware
from repro_torch.core.tiling import gemm_tiling
from repro_torch.core.workload import (Kernel, Phase, decode_phase, prefill_phase,
                                 resident_bytes)


@dataclass
class KernelTime:
    kernel: Kernel
    compute_time: float
    level_time: Dict[str, float]
    level_traffic: Dict[str, float]
    level_chunks: Dict[str, float]

    @property
    def time(self) -> float:
        mem = max(self.level_time.values(), default=0.0)
        return max(self.compute_time, mem)

    @property
    def bottleneck(self) -> str:
        mem_lv, mem_t = "", 0.0
        for lv, t in self.level_time.items():
            if t > mem_t:
                mem_lv, mem_t = lv, t
        return "compute" if self.compute_time >= mem_t else mem_lv


def _consume_chunk_bytes(hier: MemoryHierarchy) -> float:
    """Granularity of streamed transfers = last on-die staging buffer (L2)."""
    # chain[1] is L2 in the NPU presets; fall back to innermost.
    lv = hier.chain[1] if len(hier.chain) > 1 else hier.chain[0]
    return lv.capacity or 8e6


def kernel_time(k: Kernel, hier: MemoryHierarchy, place: Placement
                ) -> KernelTime:
    eff = hier.compute.gemm_efficiency if k.kind == "gemm" else 1.0
    compute_t = k.total_flops() / (hier.compute.flops * eff)
    level_time: Dict[str, float] = {}
    level_traffic: Dict[str, float] = {}
    level_chunks: Dict[str, float] = {}
    chunk_cap = _consume_chunk_bytes(hier)

    for op in k.operands:
        for (loc, frac) in place.locations(op.tclass):
            if frac <= 0.0:
                continue
            path = hier.path_from(loc)
            for lv in path:
                # re-read factor at this boundary from the tiling search
                if k.kind == "gemm":
                    staging = hier.staging_capacity(lv.name)
                    t = gemm_tiling(k.M, k.N, k.K, k.dtype_bytes, staging)
                    reread = (t.traffic[op.role]
                              / (_role_bytes(k, op.role) or 1.0))
                    traffic = op.bytes * frac * max(reread, 1.0)
                    tile = t.tile_bytes[op.role] * k.batch
                else:
                    traffic = op.bytes * frac
                    tile = traffic
                gran = op.granularity or traffic
                chunk = max(min(chunk_cap, gran, tile, traffic), 1.0)
                n_chunks = math.ceil(traffic / chunk) if traffic else 0.0
                # structural repetition (collapsed identical layers)
                traffic *= k.count
                n_chunks *= k.count
                level_traffic[lv.name] = level_traffic.get(lv.name, 0.0) + traffic
                level_chunks[lv.name] = level_chunks.get(lv.name, 0.0) + n_chunks
    for lv_name, traffic in level_traffic.items():
        lv = hier.level(lv_name)
        level_time[lv_name] = (traffic / lv.bandwidth
                               + level_chunks[lv_name] * lv.latency)
    return KernelTime(k, compute_t, level_time, level_traffic, level_chunks)


def _role_bytes(k: Kernel, role: str) -> float:
    """Per-GEMM-instance logical bytes (the tiling search is per instance)."""
    if role == "A":
        return float(k.M * k.K * k.dtype_bytes)
    if role == "B":
        return float(k.K * k.N * k.dtype_bytes)
    return float(k.M * k.N * k.dtype_bytes)


# ---------------------------------------------------------------------- #

@dataclass
class PhaseReport:
    phase: str
    total: float
    by_group: Dict[str, float]
    by_level: Dict[str, float]
    compute_time: float
    bottleneck: str
    kernel_times: List[KernelTime] = field(repr=False, default_factory=list)

    def group_share(self, *groups: str, gemm_only: bool = True) -> float:
        """Share of (GEMM) kernel time spent in the given groups (Fig. 2b)."""
        sel, tot = 0.0, 0.0
        for kt in self.kernel_times:
            if gemm_only and kt.kernel.kind != "gemm":
                continue
            tot += kt.time
            if kt.kernel.group in groups:
                sel += kt.time
        return sel / tot if tot else 0.0


def phase_time(ph: Phase, hier: MemoryHierarchy, place: Placement
               ) -> PhaseReport:
    kts = [kernel_time(k, hier, place) for k in ph.kernels]
    by_group: Dict[str, float] = {}
    by_level: Dict[str, float] = {}
    comp = 0.0
    for kt in kts:
        by_group[kt.kernel.group] = by_group.get(kt.kernel.group, 0.0) + kt.time
        comp += kt.compute_time
        for lv, t in kt.level_time.items():
            by_level[lv] = by_level.get(lv, 0.0) + t
    total = sum(kt.time for kt in kts)
    # dominant bottleneck = level (or compute) accounting for most kernel time
    tally: Dict[str, float] = {}
    for kt in kts:
        tally[kt.bottleneck] = tally.get(kt.bottleneck, 0.0) + kt.time
    bott = max(tally, key=tally.get) if tally else "compute"
    return PhaseReport(ph.name, total, by_group, by_level, comp, bott, kts)


# ---------------------------------------------------------------------- #

@dataclass
class InferenceReport:
    arch: str
    prefill_len: int
    decode_len: int
    batch: int
    prefill: PhaseReport
    decode_samples: List[Tuple[int, PhaseReport]]
    prefill_time: float
    decode_time: float
    placement: str

    @property
    def total_time(self) -> float:
        return self.prefill_time + self.decode_time

    @property
    def tps(self) -> float:
        """Tokens/s over the full request (the paper's interactivity metric)."""
        return self.batch * self.decode_len / self.total_time

    @property
    def tps_decode_only(self) -> float:
        return self.batch * self.decode_len / self.decode_time

    @property
    def bottleneck(self) -> str:
        mid = self.decode_samples[len(self.decode_samples) // 2][1]
        return mid.bottleneck

    def decode_group_share(self, *groups: str) -> Tuple[float, float]:
        shares = [r.group_share(*groups) for _, r in self.decode_samples]
        return min(shares), max(shares)


def run_inference(cfg: ArchConfig, hier: MemoryHierarchy, place: Placement,
                  prefill_len: int, decode_len: int, batch: int = 1,
                  dtype_bytes: int = 2, n_samples: int = 9,
                  capacity_check: bool = True) -> InferenceReport:
    """End-to-end TPS: prefill once + integrate decode over growing context."""
    if capacity_check:
        fp = resident_bytes(cfg, prefill_len + decode_len, batch, dtype_bytes)
        place = capacity_aware(place, hier, fp)
    pf = prefill_phase(cfg, prefill_len, batch, dtype_bytes)
    pf_rep = phase_time(pf, hier, place)
    # decode time: per-step cost is piecewise-linear in ctx -> sample + trapezoid
    lo, hi = prefill_len, prefill_len + decode_len
    n = max(2, min(n_samples, decode_len))
    xs = sorted({int(round(lo + (hi - lo) * i / (n - 1))) for i in range(n)})
    samples = [(x, phase_time(decode_phase(cfg, x, batch, dtype_bytes),
                              hier, place)) for x in xs]
    dec_t = 0.0
    for (x0, r0), (x1, r1) in zip(samples, samples[1:]):
        dec_t += 0.5 * (r0.total + r1.total) * (x1 - x0)
    if len(samples) == 1:
        dec_t = samples[0][1].total * decode_len
    return InferenceReport(cfg.name, prefill_len, decode_len, batch,
                           pf_rep, samples, pf_rep.total, dec_t, place.name)
