"""The paper's primary contribution: a hierarchical, latency-aware roofline
performance model for gen-AI inference over emerging memory technologies
(HBS, bonded SRAM chiplet), plus its retargeting at one NVIDIA H100
(``h100_roofline``, the counterpart of the reference's ``tpu_roofline``).
The model's modules are copies of the reference's; the torch-side cost
extractor (``cost_analysis``) is imported on its own."""
from repro_torch.core import (concurrency, h100_roofline, memspec, placement,
                              roofline, stco, tiling, workload)
from repro_torch.core.concurrency import (ChipletGridPoint, ConcurrencyPoint,
                                          HBSGridPoint,
                                          chiplet_interactivity_sweep,
                                          chiplet_kv_hit_frac,
                                          compounded_offload_envelope,
                                          concurrency_sweep,
                                          concurrent_inference,
                                          expected_tokens_per_pass,
                                          hbs_interactivity_sweep,
                                          kv_dedup_factor,
                                          max_concurrency_without_spill,
                                          min_hbs_bandwidth_for_itl,
                                          placement_with_kv_split,
                                          speculative_tps)
from repro_torch.core.h100_roofline import h100_hierarchy
from repro_torch.core.memspec import (ComputeSpec, MemoryHierarchy,
                                      MemoryLevel, hbs, lpddr6, npu_hierarchy,
                                      sram_chiplet, ssd_pcie,
                                      tpu_v5e_hierarchy)
from repro_torch.core.placement import (Placement, all_hbs, capacity_aware,
                                        chiplet_mlp_weights, chiplet_qkv,
                                        ddr_only, make_placement, qkv_in_ddr)
from repro_torch.core.roofline import (InferenceReport, KernelTime,
                                       PhaseReport, kernel_time, phase_time,
                                       run_inference)
from repro_torch.core.workload import (TC, Kernel, Phase, decode_phase,
                                       prefill_phase, resident_bytes)

__all__ = [
    "concurrency", "h100_roofline", "memspec", "placement", "roofline",
    "stco", "tiling", "workload",
    "ChipletGridPoint", "ConcurrencyPoint", "HBSGridPoint",
    "chiplet_interactivity_sweep", "chiplet_kv_hit_frac",
    "compounded_offload_envelope", "concurrency_sweep",
    "concurrent_inference", "expected_tokens_per_pass",
    "hbs_interactivity_sweep", "kv_dedup_factor",
    "max_concurrency_without_spill", "min_hbs_bandwidth_for_itl",
    "placement_with_kv_split", "speculative_tps",
    "h100_hierarchy",
    "ComputeSpec", "MemoryHierarchy", "MemoryLevel", "hbs", "lpddr6",
    "npu_hierarchy", "sram_chiplet", "ssd_pcie", "tpu_v5e_hierarchy",
    "Placement", "all_hbs", "capacity_aware", "chiplet_mlp_weights",
    "chiplet_qkv", "ddr_only", "make_placement", "qkv_in_ddr",
    "InferenceReport", "KernelTime", "PhaseReport", "kernel_time",
    "phase_time", "run_inference",
    "TC", "Kernel", "Phase", "decode_phase", "prefill_phase",
    "resident_bytes",
]
