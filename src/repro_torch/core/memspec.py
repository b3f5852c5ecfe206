"""Memory-system specification for the hierarchical roofline model (paper Sec. II).

A ``MemoryHierarchy`` is an ordered chain of ``MemoryLevel``s from the level
closest to compute (NPU scratchpad) outward (DDR, HBS).  *Side tiers* (the
paper's hybrid-bonded SRAM chiplet) attach at a chain position: tensors placed
there stream straight to the inner levels without crossing the outer chain.

Units: bytes, bytes/s, seconds.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, Optional, Tuple

GB = 1e9
MB = 1e6
KB = 1e3
US = 1e-6
NS = 1e-9


@dataclass(frozen=True)
class MemoryLevel:
    name: str
    capacity: Optional[float]      # bytes; None = effectively unbounded
    bandwidth: float               # bytes/s sustained
    latency: float = 0.0           # seconds per chunk issue (non-overlapped)

    def replace(self, **kw) -> "MemoryLevel":
        return replace(self, **kw)


@dataclass(frozen=True)
class ComputeSpec:
    name: str
    flops: float                   # peak FLOP/s at the working precision
    # efficiency multiplier applied to peak for GEMM-shaped work (MXU/PE
    # utilisation); the paper uses plain peak => 1.0 for NPU presets.
    gemm_efficiency: float = 1.0


@dataclass(frozen=True)
class MemoryHierarchy:
    """Chain ordered innermost-first + optional side tiers.

    ``side_tiers`` maps tier name -> (MemoryLevel, attach_pos); a tensor
    placed on a side tier crosses that tier's boundary and then every chain
    boundary *below* attach_pos (paper: chiplet sits "at the same footing as
    L2", attach_pos = index of L2).
    """
    compute: ComputeSpec
    chain: Tuple[MemoryLevel, ...]                 # innermost first
    side_tiers: Dict[str, Tuple[MemoryLevel, int]] = field(default_factory=dict)

    # ------------------------------------------------------------------ #
    def level(self, name: str) -> MemoryLevel:
        for lv in self.chain:
            if lv.name == name:
                return lv
        if name in self.side_tiers:
            return self.side_tiers[name][0]
        raise KeyError(f"no memory level {name!r}")

    def chain_pos(self, name: str) -> int:
        for i, lv in enumerate(self.chain):
            if lv.name == name:
                return i
        if name in self.side_tiers:
            return self.side_tiers[name][1]
        raise KeyError(f"no memory level {name!r}")

    def path_from(self, name: str) -> Tuple[MemoryLevel, ...]:
        """Levels whose *outbound* boundary the tensor's bytes cross.

        For a tensor resident at `name`, bytes are read out of `name`, then
        out of every chain level strictly inside it, down to (excluding) the
        innermost level (whose inner boundary is the register file, treated
        as free).
        """
        if name in self.side_tiers:
            tier, pos = self.side_tiers[name]
            # attach_pos = chain index the tier sits BESIDE: data from the
            # tier crosses the same inner boundaries as data resident there.
            return (tier,) + tuple(self.chain[1:pos])[::-1]
        pos = self.chain_pos(name)
        return tuple(self.chain[1:pos + 1])[::-1] if pos > 0 else ()

    def outermost(self) -> MemoryLevel:
        return self.chain[-1]

    def with_level(self, name: str, **kw) -> "MemoryHierarchy":
        new_chain = tuple(lv.replace(**kw) if lv.name == name else lv
                          for lv in self.chain)
        new_side = {k: (lv.replace(**kw) if k == name else lv, pos)
                    for k, (lv, pos) in self.side_tiers.items()}
        return replace(self, chain=new_chain, side_tiers=new_side)

    def with_side_tier(self, name: str, level: MemoryLevel,
                       attach_pos: int) -> "MemoryHierarchy":
        side = dict(self.side_tiers)
        side[name] = (level, attach_pos)
        return replace(self, side_tiers=side)

    # staging capacity just inside a given level: bounds transfer chunk size
    def staging_capacity(self, name: str) -> float:
        pos = self.chain_pos(name)
        if pos <= 0:
            return self.chain[0].capacity or 0.0
        inner = self.chain[pos - 1]
        return inner.capacity if inner.capacity else 64 * MB


# ===================================================================== #
# Presets (paper Sec. III experiment design)                            #
# ===================================================================== #

def npu_compute(tflops: float = 35.0) -> ComputeSpec:
    """The paper's single-NPU instance: 35 TFLOP/s across all PEs."""
    return ComputeSpec("npu-35T", flops=tflops * 1e12)


def scratchpad(mb: float = 2.0) -> MemoryLevel:
    return MemoryLevel("spm", capacity=mb * MB, bandwidth=8e12, latency=20 * NS)


def l2(mb: float = 8.0) -> MemoryLevel:
    return MemoryLevel("l2", capacity=mb * MB, bandwidth=2e12, latency=50 * NS)


def lpddr6(bw_gbps: float = 173.0, latency_ns: float = 100.0,
           capacity_gb: float = 16.0, name: str = "ddr") -> MemoryLevel:
    """LPDDR6 (173 GB/s) or 3x-stacked (520 GB/s) per the paper."""
    return MemoryLevel(name, capacity=capacity_gb * GB, bandwidth=bw_gbps * GB,
                       latency=latency_ns * NS)


def hbs(bw_gbps: float, latency_us: float, capacity_gb: float = 1024.0
        ) -> MemoryLevel:
    """High Bandwidth Storage: NAND with many small planes, 16 IO/plane,
    1-4 Gb/s per IO => DDR-class bandwidth at microsecond latency."""
    return MemoryLevel("hbs", capacity=capacity_gb * GB, bandwidth=bw_gbps * GB,
                       latency=latency_us * US)


def ssd_pcie(gen: int = 5) -> MemoryLevel:
    """Baseline offload tier the paper compares against: PCIe Gen5/Gen6 SSD."""
    bw = {5: 16.0, 6: 32.0}[gen]
    return MemoryLevel("ssd", capacity=2048 * GB, bandwidth=bw * GB,
                       latency=80 * US)


def sram_chiplet(bw_gbps: float, capacity_mb: float = 128.0,
                 latency_ns: float = 50.0) -> MemoryLevel:
    """Hybrid-bonded SRAM global-buffer chiplet (paper Sec. III, Fig. 4).

    >68 MB so it holds Q + KV of small models; custom interface to the NPU
    logic die, bandwidth swept 173 GB/s - 1 TB/s in the paper."""
    return MemoryLevel("chiplet", capacity=capacity_mb * MB,
                       bandwidth=bw_gbps * GB, latency=latency_ns * NS)


def npu_hierarchy(ddr: MemoryLevel, hbs_level: Optional[MemoryLevel] = None,
                  chiplet: Optional[MemoryLevel] = None,
                  tflops: float = 35.0, spm_mb: float = 2.0,
                  l2_mb: float = 8.0) -> MemoryHierarchy:
    """Paper base hierarchy: spm - L2 - DDR [- HBS] [+ chiplet beside L2]."""
    chain = [scratchpad(spm_mb), l2(l2_mb), ddr]
    if hbs_level is not None:
        chain.append(hbs_level)
    h = MemoryHierarchy(compute=npu_compute(tflops), chain=tuple(chain))
    if chiplet is not None:
        h = h.with_side_tier("chiplet", chiplet, attach_pos=1)  # beside L2
    return h


# --------------------------- TPU v5e target --------------------------- #
# Deliverable (g): the same engine retargeted at the production pod.
V5E_PEAK_BF16 = 197e12          # FLOP/s per chip
V5E_HBM_BW = 819e9              # bytes/s per chip
V5E_ICI_BW = 50e9               # bytes/s per link
V5E_HBM_GB = 16.0
V5E_VMEM_MB = 128.0


def tpu_v5e_hierarchy() -> MemoryHierarchy:
    chain = (
        MemoryLevel("vmem", capacity=V5E_VMEM_MB * MB, bandwidth=40e12,
                    latency=0.0),
        MemoryLevel("hbm", capacity=V5E_HBM_GB * GB, bandwidth=V5E_HBM_BW,
                    latency=1 * US),
        MemoryLevel("ici", capacity=None, bandwidth=V5E_ICI_BW,
                    latency=1 * US),
    )
    return MemoryHierarchy(
        compute=ComputeSpec("tpu-v5e", flops=V5E_PEAK_BF16), chain=chain)
