"""Paper Fig. 2: (a) TPS vs HBS bw at 10us for configs I/II/III;
(b) per-GEMM time breakdown for HBS latency 10us vs 50us at 512 GB/s.

Derived: attention share of total GEMM time (paper: 31-69 % for 10-50 us).
"""
from __future__ import annotations

from repro_torch.configs import get_config
from repro_torch.core import (all_hbs, hbs, lpddr6, npu_hierarchy, qkv_in_ddr,
                        run_inference)

HBS_BWS = (16, 64, 128, 173, 256, 384, 512)

CONFIGS = (
    ("I", 173.0, all_hbs()),
    ("II", 520.0, all_hbs()),
    ("III", 520.0, qkv_in_ddr()),
)


def run(emit) -> str:
    cfg = get_config("llava15-13b")
    for label, ddr_bw, place in CONFIGS:
        pts = []
        for bw in HBS_BWS:
            hier = npu_hierarchy(lpddr6(ddr_bw), hbs(bw, latency_us=10.0))
            rep = run_inference(cfg, hier, place, 200, 200, dtype_bytes=2)
            pts.append(f"{bw}:{rep.tps:.2f}")
        emit(f"fig2a.cfg{label}", 0.0, "tps[" + " ".join(pts) + "]")

    # (b) per-layer GEMM breakdown at 512 GB/s for two latencies
    shares = []
    for lat in (10.0, 50.0):
        hier = npu_hierarchy(lpddr6(520.0), hbs(512.0, latency_us=lat))
        rep = run_inference(cfg, hier, all_hbs(), 200, 200, dtype_bytes=2)
        mid = rep.decode_samples[len(rep.decode_samples) // 2][1]
        per_layer = {g: t / cfg.n_layers * 1e3 for g, t in mid.by_group.items()
                     if g != "elem"}
        emit(f"fig2b.lat{lat:g}us", 0.0,
             "ms/layer[" + " ".join(f"{g}:{v:.3f}" for g, v in
                                    sorted(per_layer.items())) + "]")
        lo, hi = rep.decode_group_share("attn")
        shares.append(hi)
    return (f"attn_share@10us={shares[0]*100:.0f}% @50us={shares[1]*100:.0f}% "
            f"(paper 31-69%)")
