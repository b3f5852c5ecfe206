"""Paper Fig. 1: TPS vs HBS bandwidth x latency, DDR at 173 / 520 GB/s.

LLaVa-1.5-13B FP16, prefill/decode 200/200, 35 TFLOP/s NPU.
Derived: saturation TPS per panel + the HBS:DDR bandwidth ratio at which the
bottleneck shifts to DDR (paper takeaway I: ~1.4x).
"""
from __future__ import annotations

from repro_torch.configs import get_config
from repro_torch.core import all_hbs, hbs, lpddr6, npu_hierarchy, run_inference

HBS_BWS = (16, 32, 64, 128, 173, 256, 384, 512)
LATENCIES_US = (2.0, 10.0, 50.0, 100.0)


def tps_at(ddr_bw: float, hbs_bw: float, lat_us: float) -> object:
    cfg = get_config("llava15-13b")
    hier = npu_hierarchy(lpddr6(ddr_bw), hbs(hbs_bw, latency_us=lat_us))
    return run_inference(cfg, hier, all_hbs(), 200, 200, dtype_bytes=2)


def sweep(ddr_bw: float):
    grid = {}
    for lat in LATENCIES_US:
        for bw in HBS_BWS:
            rep = tps_at(ddr_bw, bw, lat)
            grid[(lat, bw)] = (rep.tps, rep.bottleneck)
    return grid


def shift_ratio(grid, ddr_bw: float) -> float:
    """Lowest HBS:DDR bw ratio where the mid-latency curve goes DDR-bound."""
    for bw in HBS_BWS:
        tps, bott = grid[(10.0, bw)]
        if bott == "ddr":
            return bw / ddr_bw
    return float("inf")


def run(emit) -> str:
    derived = []
    for panel, ddr_bw in (("a", 173.0), ("b", 520.0)):
        grid = sweep(ddr_bw)
        for lat in LATENCIES_US:
            pts = " ".join(f"{bw}:{grid[(lat, bw)][0]:.2f}" for bw in HBS_BWS)
            emit(f"fig1{panel}.lat{lat:g}us", 0.0, f"tps[{pts}]")
        sat = max(grid[(2.0, bw)][0] for bw in HBS_BWS)
        ratio = shift_ratio(grid, ddr_bw)
        meets = sat >= 10.0
        derived.append(f"panel{panel}: sat_tps={sat:.2f} shift@{ratio:.2f}xDDR "
                       f"10tps={'yes' if meets else 'no'}")
    return "; ".join(derived)
