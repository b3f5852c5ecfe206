"""Paper Fig. 3: context scaling — prefill/decode up to 8192/24576.

HBS fixed at 512 GB/s / 10 us. Derived: monotonic TPS degradation with
context + consistent relative gains (paper) + the ~27 GB KV @ 33k claim.
"""
from __future__ import annotations

from repro_torch.configs import get_config
from repro_torch.core import (all_hbs, hbs, lpddr6, npu_hierarchy, qkv_in_ddr,
                        run_inference)

CONTEXTS = ((200, 200), (4096, 12288), (8192, 24576))
CONFIGS = (
    ("I", 173.0, all_hbs()),
    ("II", 520.0, all_hbs()),
    ("III", 520.0, qkv_in_ddr()),
)


def run(emit) -> str:
    cfg = get_config("llava15-13b")
    kv33k = cfg.kv_bytes_per_token(2) * (8192 + 24576) / 1e9
    table = {}
    for label, ddr_bw, place in CONFIGS:
        for pf, dec in CONTEXTS:
            hier = npu_hierarchy(lpddr6(ddr_bw), hbs(512.0, latency_us=10.0),)
            rep = run_inference(cfg, hier, place, pf, dec, dtype_bytes=2,
                                n_samples=7)
            table[(label, pf)] = rep.tps
        pts = " ".join(f"{pf}+{dec}:{table[(label, pf)]:.2f}"
                       for pf, dec in CONTEXTS)
        emit(f"fig3.cfg{label}", 0.0, f"tps[{pts}]")
    mono = all(table[(lbl, 200)] >= table[(lbl, 4096)] >= table[(lbl, 8192)]
               for lbl, _, _ in CONFIGS)
    gains = [table[("III", pf)] / table[("I", pf)] for pf, _ in CONTEXTS]
    spread = max(gains) / min(gains)
    return (f"kv@33k={kv33k:.1f}GB(paper~27) monotonic={mono} "
            f"III/I_gain={gains[0]:.2f}/{gains[1]:.2f}/{gains[2]:.2f} "
            f"consistency={spread:.2f}x")
