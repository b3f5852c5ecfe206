"""Paper Fig. 4 + takeaway IV: SRAM chiplet for Llama-3.2-1B (128/384).

Sweeps chiplet bandwidth for several DDR latencies; compares QKV-in-chiplet
vs MLP/projection-weights-in-chiplet, BOTH capacity-limited (128 MB, honest)
and idealised (unbounded, the paper's implicit assumption) — the capacity
split is a beyond-paper contribution.
"""
from __future__ import annotations

from repro_torch.configs import get_config
from repro_torch.core import (chiplet_mlp_weights, chiplet_qkv, ddr_only, lpddr6,
                        npu_hierarchy, run_inference, sram_chiplet)

CH_BWS = (173.0, 512.0, 1000.0)
DDR_LATS_NS = (100.0, 500.0, 1000.0)


def run(emit) -> str:
    cfg = get_config("llama3.2-1b")
    attn_shares = []
    pm_shares = []
    ideal_better = 0
    for lat in DDR_LATS_NS:
        base = run_inference(cfg, npu_hierarchy(lpddr6(173.0, latency_ns=lat)),
                             ddr_only(), 128, 384, dtype_bytes=2)
        a_lo, a_hi = base.decode_group_share("attn")
        # paper's Sec-II kernel list has no LM-head GEMM -> exclude "embed"
        mid = base.decode_samples[len(base.decode_samples) // 2][1]
        gemm_t = {g: 0.0 for g in ("attn", "proj", "mlp", "qkv_gen", "embed")}
        for kt in mid.kernel_times:
            if kt.kernel.kind == "gemm":
                gemm_t[kt.kernel.group] = gemm_t.get(kt.kernel.group, 0.0) + kt.time
        core = sum(v for g, v in gemm_t.items() if g != "embed")
        attn_shares.append(gemm_t["attn"] / core)
        pm_shares.append((gemm_t["proj"] + gemm_t["mlp"]) / core)
        rows = [f"base:{base.tps:.1f}"]
        for cbw in CH_BWS:
            for cap, tag in ((128.0, "128MB"), (4096.0, "ideal")):
                h = npu_hierarchy(lpddr6(173.0, latency_ns=lat),
                                  chiplet=sram_chiplet(cbw, capacity_mb=cap))
                r_q = run_inference(cfg, h, chiplet_qkv(), 128, 384,
                                    dtype_bytes=2)
                r_w = run_inference(cfg, h, chiplet_mlp_weights(), 128, 384,
                                    dtype_bytes=2)
                rows.append(f"{cbw:g}GB/s.{tag}:qkv={r_q.tps:.1f}"
                            f"/w={r_w.tps:.1f}")
                if tag == "ideal" and r_w.tps > r_q.tps:
                    ideal_better += 1
        emit(f"fig4.ddr_lat{lat:g}ns", 0.0, " ".join(rows))
    return (f"attn_share={min(attn_shares)*100:.0f}-{max(attn_shares)*100:.0f}%"
            f"(paper 4-9) proj+mlp={min(pm_shares)*100:.0f}-"
            f"{max(pm_shares)*100:.0f}%(paper 82-86) "
            f"takeawayIV_ideal={ideal_better}/{len(DDR_LATS_NS)*len(CH_BWS)}")
