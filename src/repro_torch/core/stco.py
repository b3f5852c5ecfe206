"""System-Technology Co-Optimization driver (paper Sec. III methodology,
generalized): sweep (hierarchy x placement x model x context) -> TPS /
bottleneck / breakdown tables, plus requirement solvers ("what bandwidth /
latency does tier X need to reach T TPS?" — the paper's Fig. 1 question
asked programmatically).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.configs.base import ArchConfig
from repro_torch.core.memspec import MemoryHierarchy, hbs, lpddr6, npu_hierarchy
from repro_torch.core.placement import Placement
from repro_torch.core.roofline import run_inference


@dataclass(frozen=True)
class SweepPoint:
    arch: str
    hierarchy: str
    placement: str
    prefill: int
    decode: int
    tps: float
    bottleneck: str
    attn_share: float


def sweep(cfgs: Sequence[ArchConfig],
          hierarchies: Dict[str, MemoryHierarchy],
          placements: Sequence[Placement],
          contexts: Sequence[Tuple[int, int]],
          *, batch: int = 1, dtype_bytes: int = 2,
          n_samples: int = 5) -> List[SweepPoint]:
    """Full-factorial STCO sweep; one engine configuration for all points."""
    def adapt(place: Placement, hier: MemoryHierarchy) -> Placement:
        """Remap tensor classes whose tier is absent to the outermost level
        (an all-in-HBS policy on an HBS-less hierarchy means all-in-DDR)."""
        names = {lv.name for lv in hier.chain} | set(hier.side_tiers)
        fallback = hier.outermost().name
        mapping = {c: (lv if lv in names else fallback)
                   for c, lv in place.mapping.items()}
        if mapping == place.mapping:
            return place
        return Placement(place.name, mapping, place.splits)

    out: List[SweepPoint] = []
    for cfg in cfgs:
        for hname, hier in hierarchies.items():
            for placement in placements:
                place = adapt(placement, hier)
                for pf, dec in contexts:
                    rep = run_inference(cfg, hier, place, pf, dec,
                                        batch=batch, dtype_bytes=dtype_bytes,
                                        n_samples=n_samples)
                    out.append(SweepPoint(
                        cfg.name, hname, place.name, pf, dec, rep.tps,
                        rep.bottleneck,
                        rep.decode_group_share("attn")[1]))
    return out


def required_bandwidth(cfg: ArchConfig, place: Placement, *,
                       target_tps: float, level: str = "hbs",
                       latency_us: float = 10.0, ddr_bw: float = 520.0,
                       prefill: int = 512, decode: int = 512,
                       lo: float = 8.0, hi: float = 4096.0,
                       tol: float = 0.02) -> Optional[float]:
    """Minimum ``level`` bandwidth (GB/s) reaching ``target_tps``
    (bisection over the monotone TPS(bw) curve — paper Fig. 1 inverted)."""
    def tps_at(bw: float) -> float:
        hier = npu_hierarchy(lpddr6(ddr_bw), hbs(bw, latency_us=latency_us))
        return run_inference(cfg, hier, place, prefill, decode,
                             n_samples=5).tps
    if tps_at(hi) < target_tps:
        return None
    while hi / lo > 1 + tol:
        mid = (lo * hi) ** 0.5
        if tps_at(mid) >= target_tps:
            hi = mid
        else:
            lo = mid
    return hi


def max_tolerable_latency(cfg: ArchConfig, place: Placement, *,
                          target_tps: float, bw_gbps: float = 512.0,
                          ddr_bw: float = 520.0, prefill: int = 512,
                          decode: int = 512, lo_us: float = 0.1,
                          hi_us: float = 1000.0) -> Optional[float]:
    """Largest HBS latency (us) still meeting the target (Fig. 1 y-axis
    question: which latency curves cross 10 TPS?)."""
    def tps_at(lat: float) -> float:
        hier = npu_hierarchy(lpddr6(ddr_bw), hbs(bw_gbps, latency_us=lat))
        return run_inference(cfg, hier, place, prefill, decode,
                             n_samples=5).tps
    if tps_at(lo_us) < target_tps:
        return None
    lo, hi = lo_us, hi_us
    while hi / lo > 1.05:
        mid = (lo * hi) ** 0.5
        if tps_at(mid) >= target_tps:
            lo = mid
        else:
            hi = mid
    return lo
