"""The paper's roofline methodology retargeted at one NVIDIA H100 SXM (the
port's counterpart of the reference's ``core/tpu_roofline.py``).

Converts a step's measured costs (``core/cost_analysis.py``: FLOPs, bytes
and collective bytes of the aten ops it dispatches) into the three roofline
terms, gives the analytic "compulsory traffic" floor of a decode step, and
builds the H100 as a ``MemoryHierarchy`` for the hierarchical engine
(``core/roofline.py``): shared memory and L2 on the die, HBM3 in the
``ddr`` slot, host DRAM over PCIe in the ``hbs`` slot, so the paper's
placements (``all-hbm``, KV in host DRAM) keep their meaning.

Constants are NVIDIA's published figures for the SXM part:
- data sheet: https://resources.nvidia.com/en-us-tensor-core/nvidia-tensor-core-gpu-datasheet
- Hopper whitepaper: https://resources.nvidia.com/en-us-tensor-core/gtc22-whitepaper-hopper
- CUDA C++ Programming Guide (compute capability 9.0, shared memory):
  https://docs.nvidia.com/cuda/cuda-c-programming-guide/
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.configs.base import ArchConfig
from repro_torch.core.memspec import (GB, KB, MB, ComputeSpec,
                                      MemoryHierarchy, MemoryLevel)
from repro_torch.core.placement import Placement
from repro_torch.core.roofline import run_inference

# data sheet, "H100 SXM" column, dense rates (the sheet's tensor-core
# figures are with sparsity; dense is half): BF16/FP16 tensor core
# 1,979 / 2 TFLOP/s, FP32 67 TFLOP/s, 80 GB of HBM3 at 3.35 TB/s, NVLink
# 900 GB/s (both directions together), PCIe Gen5 128 GB/s (both
# directions together)
H100_PEAK_BF16 = 989e12
H100_PEAK_F32 = 67e12
H100_HBM_BW = 3.35e12
H100_HBM_GB = 80.0
H100_NVLINK_BW = 450e9          # one direction of 900 GB/s
H100_PCIE_BW = 64e9             # one direction of PCIe Gen5 x16's 128 GB/s
# whitepaper, H100 SXM5: 132 SMs, up to 228 KB of shared memory an SM,
# a 50 MB L2 cache; an SM's four tensor cores do 4 x 512 dense FP16/BF16
# FMA a clock (twice A100's), 4,096 FLOP
H100_SMS = 132
H100_SMEM_KB_PER_SM = 228.0
H100_L2_MB = 50.0
_DENSE_BF16_FLOP_PER_SM_CLOCK = 4096
# the SM clock the data sheet's dense bf16 rate implies: 1.83 GHz
H100_SM_CLOCK = H100_PEAK_BF16 / (H100_SMS * _DENSE_BF16_FLOP_PER_SM_CLOCK)
# programming guide: shared memory has 32 banks of 4 bytes, one access a
# bank a clock -> 128 B a clock an SM
H100_SMEM_BW = H100_SMS * 128 * H100_SM_CLOCK
# NVIDIA publishes no L2 rate. The model gives L2 the shared-memory rate:
# both on-die levels are then ~9x faster than HBM and bind no kernel that
# streams from HBM, which is the regime phase 19 holds against the card.
H100_L2_BW = H100_SMEM_BW
# host DRAM behind PCIe (the "hbs" slot): its capacity is the host's, not
# an H100 figure; 512 GB as the reference's TPU serving node assumes
HOST_DRAM_GB = 512.0


@dataclass(frozen=True)
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    hlo_flops_global: float

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_lower_bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        return self.compute_s / max(self.step_lower_bound_s, 1e-30)

    @property
    def model_flops_ratio(self) -> float:
        return self.model_flops / max(self.hlo_flops_global, 1.0)


def terms_from_costs(costs, *, n_dev: int, model_flops: float,
                     peak: float = H100_PEAK_BF16, hbm_bw: float = H100_HBM_BW,
                     link_bw: float = H100_NVLINK_BW) -> RooflineTerms:
    """``costs``: anything with ``flops``, ``bytes`` and
    ``collective_bytes`` a device (``cost_analysis.OpCosts``, or the
    reference's ``HloCosts``)."""
    return RooflineTerms(
        compute_s=costs.flops / peak,
        memory_s=costs.bytes / hbm_bw,
        collective_s=costs.collective_bytes / link_bw,
        model_flops=model_flops,
        hlo_flops_global=costs.flops * n_dev,
    )


def model_flops_for(cfg: ArchConfig, kind: str, seq_len: int,
                    global_batch: int) -> float:
    """MODEL_FLOPS = 6·N_active·D (train) / 2·N_active·D (inference)."""
    n_act = cfg.n_active_params()
    if kind == "train":
        return 6.0 * n_act * seq_len * global_batch
    if kind == "prefill":
        return 2.0 * n_act * seq_len * global_batch
    return 2.0 * n_act * global_batch


def decode_compulsory_bytes(cfg: ArchConfig, ctx: int, batch: int,
                            n_dev: int, dtype_bytes: int = 2) -> float:
    """Per-device compulsory device-memory traffic of one decode step:
    every active weight byte once + the KV cache once (the paper's
    ops:bytes ~ O(1) memory-wall floor)."""
    weights = cfg.n_active_params() * dtype_bytes
    kv = cfg.kv_bytes_per_token(dtype_bytes) * ctx * batch
    return (weights + kv) / n_dev


def decode_floor_seconds(cfg: ArchConfig, ctx: int, batch: int,
                         n_dev: int = 1, hbm_bw: float = H100_HBM_BW) -> float:
    return decode_compulsory_bytes(cfg, ctx, batch, n_dev) / hbm_bw


def h100_hierarchy(*, flops: float = H100_PEAK_BF16,
                   hbm_bw: float = H100_HBM_BW, hbm_latency: float = 0.0,
                   hbm_gb: float = H100_HBM_GB,
                   host_bw: float = H100_PCIE_BW, host_latency: float = 0.0,
                   host_gb: float = HOST_DRAM_GB) -> MemoryHierarchy:
    """One H100 SXM as the paper's chain: smem - L2 - HBM ("ddr") - host
    DRAM over PCIe ("hbs"). Rates in bytes/s and FLOP/s, latencies in
    seconds a transfer chunk, capacities in GB; the defaults are the
    published figures, and a caller passes measured ones in their place.

    HBM's per-chunk latency defaults to 0: a GPU keeps enough loads in
    flight on a stream (many warps on 132 SMs, each with outstanding
    requests) to hide the DRAM latency behind the transfer, which the
    model's non-overlapped per-chunk term does not express. The host
    tier's latency defaults to 0 too: NVIDIA publishes none, and the
    intercept of a measured copy-time line takes its place."""
    chain = (
        MemoryLevel("smem", capacity=H100_SMS * H100_SMEM_KB_PER_SM * KB,
                    bandwidth=H100_SMEM_BW, latency=0.0),
        MemoryLevel("l2", capacity=H100_L2_MB * MB, bandwidth=H100_L2_BW,
                    latency=0.0),
        MemoryLevel("ddr", capacity=hbm_gb * GB, bandwidth=hbm_bw,
                    latency=hbm_latency),
        MemoryLevel("hbs", capacity=host_gb * GB, bandwidth=host_bw,
                    latency=host_latency),
    )
    return MemoryHierarchy(compute=ComputeSpec("h100-sxm", flops=flops),
                           chain=chain)


def _bisect(tps_at, target: float, lo: float, hi: float,
            tol: float) -> Optional[float]:
    """The least x in [lo, hi] (to a factor 1 + ``tol``) with
    ``tps_at(x) >= target`` over a monotone ``tps_at``; None when even
    ``hi`` falls short."""
    if tps_at(hi) < target:
        return None
    while hi / lo > 1 + tol:
        mid = (lo * hi) ** 0.5
        if tps_at(mid) >= target:
            hi = mid
        else:
            lo = mid
    return hi


def required_level_bandwidth(cfg: ArchConfig, hier: MemoryHierarchy,
                             place: Placement, *, target_tps: float,
                             prefill: int, decode: int, level: str = "hbs",
                             dtype_bytes: int = 2, lo: float = 8.0,
                             hi: float = 4096.0, tol: float = 0.02
                             ) -> Optional[float]:
    """``stco.required_bandwidth``'s question asked of any hierarchy (the
    reference's asks only of the paper's NPU chain): the least ``level``
    bandwidth, GB/s, at which one request's decode holds ``target_tps``
    tokens/s over the positions ``prefill`` .. ``prefill + decode`` (the
    decode rate, so a long prompt's prefill does not enter it). None when
    even ``hi`` falls short."""
    def tps_at(bw: float) -> float:
        h = hier.with_level(level, bandwidth=bw * GB)
        return run_inference(cfg, h, place, prefill, decode,
                             dtype_bytes=dtype_bytes,
                             n_samples=5).tps_decode_only
    return _bisect(tps_at, target_tps, lo, hi, tol)
