"""Paper Table I: the four headline configurations for LLaVa-1.5-13B 200/200.

Derived: TPS + bottleneck per row and the relative gains vs row 1
(paper: ~4 / ~5.5 (1.4x) / ~8.9 (2.2x) / ~12.5 (3.1x)).
"""
from __future__ import annotations

from repro_torch.configs import get_config
from repro_torch.core import (all_hbs, hbs, lpddr6, npu_hierarchy, qkv_in_ddr,
                        run_inference)

PAPER = (4.0, 5.5, 8.9, 12.5)

ROWS = (
    ("lpddr6+hbs<=173.all-hbs", 173.0, 173.0, all_hbs()),
    ("lpddr6+hbs<=520.all-hbs", 173.0, 520.0, all_hbs()),
    ("3xddr+hbs<=520.all-hbs", 520.0, 512.0, all_hbs()),
    ("3xddr+hbs512.qkv-in-ddr", 520.0, 512.0, qkv_in_ddr()),
)


def compute_rows():
    cfg = get_config("llava15-13b")
    out = []
    for name, ddr_bw, hbs_bw, place in ROWS:
        hier = npu_hierarchy(lpddr6(ddr_bw), hbs(hbs_bw, latency_us=10.0))
        rep = run_inference(cfg, hier, place, 200, 200, dtype_bytes=2)
        out.append((name, rep.tps, rep.bottleneck))
    return out


def run(emit) -> str:
    rows = compute_rows()
    base = rows[0][1]
    gains = []
    for (name, tps, bott), paper_tps in zip(rows, PAPER):
        gain = tps / base
        gains.append(gain)
        emit(f"table1.{name}", 0.0,
             f"tps={tps:.2f} paper~{paper_tps} gain={gain:.2f}x bott={bott}")
    return (f"tps={rows[0][1]:.1f}/{rows[1][1]:.1f}/{rows[2][1]:.1f}/"
            f"{rows[3][1]:.1f} gains={gains[1]:.2f}/{gains[2]:.2f}/"
            f"{gains[3]:.2f} (paper 1.4/2.2/3.1)")
