"""System-Technology Co-Optimization sweep (the paper's methodology,
extended beyond the paper): for EVERY architecture in the assigned pool,
find the cheapest memory technology configuration that reaches 10 TPS
interactivity at batch 1 (the reference's ``examples/stco_sweep.py``).

Run: PYTHONPATH=src python -m repro_torch.paper.stco_sweep
"""
from repro_torch.configs import ASSIGNED_ARCHS, PAPER_ARCHS, get_config
from repro_torch.core import (all_hbs, ddr_only, hbs, lpddr6, npu_hierarchy,
                              qkv_in_ddr, run_inference)

CANDIDATES = [
    # (label, relative cost rank, hierarchy factory, placement)
    ("LPDDR6 only", 0,
     lambda: npu_hierarchy(lpddr6(173.0)), ddr_only()),
    ("3x LPDDR6 only", 1,
     lambda: npu_hierarchy(lpddr6(520.0)), ddr_only()),
    ("LPDDR6 + HBS512/10us (qkv-in-ddr)", 2,
     lambda: npu_hierarchy(lpddr6(173.0), hbs(512.0, 10.0)), qkv_in_ddr()),
    ("3xLPDDR6 + HBS512/10us (qkv-in-ddr)", 3,
     lambda: npu_hierarchy(lpddr6(520.0), hbs(512.0, 10.0)), qkv_in_ddr()),
]


def main() -> None:
    print(f"{'arch':22s} {'params':>8s}  cheapest config reaching 10 TPS "
          f"(prefill/decode 512/512)")
    for arch in ASSIGNED_ARCHS + PAPER_ARCHS:
        cfg = get_config(arch)
        fit_label, fit_tps = "NONE (needs faster memory)", 0.0
        for label, _, mk_hier, place in CANDIDATES:
            hier = mk_hier()
            # DDR-only candidates must actually hold the model
            weights = cfg.n_params() * 2
            ddr_cap = hier.level("ddr").capacity
            if "only" in label and weights > ddr_cap:
                continue
            rep = run_inference(cfg, hier, place, 512, 512, n_samples=5)
            if rep.tps >= 10.0:
                fit_label, fit_tps = label, rep.tps
                break
        print(f"{arch:22s} {cfg.n_params()/1e9:7.1f}B  {fit_label} "
              f"{'(TPS %.1f)' % fit_tps if fit_tps else ''}")


if __name__ == "__main__":
    main()
