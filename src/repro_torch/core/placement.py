"""Tensor-class -> memory-tier placement (the paper's central knob).

A ``Placement`` maps each tensor class to the memory level it RESIDES at.
``capacity_aware`` splits a class across its preferred tier and a fallback
when the preferred tier cannot hold the class footprint (e.g. a 128 MB SRAM
chiplet asked to hold 1.6 GB of MLP weights) — the paper's takeaway-IV
proposal evaluated under a real capacity constraint (beyond-paper).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

from repro_torch.core.memspec import MemoryHierarchy
from repro_torch.core.workload import TC


@dataclass(frozen=True)
class Placement:
    """class -> level name; ``splits``: class -> [(level, fraction), ...]."""
    name: str
    mapping: Dict[str, str]
    splits: Dict[str, Tuple[Tuple[str, float], ...]] = field(default_factory=dict)

    def locations(self, tclass: str) -> Tuple[Tuple[str, float], ...]:
        if tclass in self.splits:
            return self.splits[tclass]
        return ((self.mapping[tclass], 1.0),)


def uniform(name: str, level: str) -> Placement:
    return Placement(name, {c: level for c in TC.ALL})


def make_placement(name: str, default: str, **over: str) -> Placement:
    m = {c: default for c in TC.ALL}
    for k, v in over.items():
        m[getattr(TC, k.upper())] = v
    return Placement(name, m)


# --------------------- the paper's configurations --------------------- #

def all_hbs() -> Placement:
    """Experiments I & II: Q, K, V, weights and activations reside on HBS."""
    return make_placement("all-hbs", "hbs")


def qkv_in_ddr() -> Placement:
    """Experiment III: Q/K/V + intermediate activations restricted to DDR."""
    return make_placement("qkv-in-ddr", "hbs",
                          qkv="ddr", kv="ddr", act="ddr", state="ddr")


def ddr_only() -> Placement:
    """No-HBS baseline (model must fit DDR): everything in DDR."""
    return make_placement("ddr-only", "ddr")


def chiplet_qkv() -> Placement:
    """Fig. 4: Q + KV cache + attention intermediates on the bonded chiplet."""
    return make_placement("chiplet-qkv", "ddr",
                          qkv="chiplet", kv="chiplet", state="chiplet")


def chiplet_mlp_weights() -> Placement:
    """Takeaway IV proposal: chiplet holds MLP + projection weights."""
    return make_placement("chiplet-w-mlp", "ddr",
                          w_mlp="chiplet", w_attn="chiplet")


def capacity_aware(p: Placement, hier: MemoryHierarchy,
                   footprints: Dict[str, float]) -> Placement:
    """Split classes whose footprint exceeds the preferred tier's capacity.

    Greedy in descending footprint: what fits stays; the remainder of the
    class spills to the innermost chain level that can absorb it (DDR, else
    the outermost level)."""
    used: Dict[str, float] = {}
    splits: Dict[str, Tuple[Tuple[str, float], ...]] = {}
    fallback_order = [lv.name for lv in hier.chain[2:]] or [hier.outermost().name]
    for tclass in sorted(footprints, key=lambda c: -footprints[c]):
        level = p.mapping[tclass]
        need = footprints.get(tclass, 0.0)
        cap = hier.level(level).capacity
        if cap is None or need <= 0:
            continue
        avail = max(cap - used.get(level, 0.0), 0.0)
        if need <= avail:
            used[level] = used.get(level, 0.0) + need
            continue
        fit = avail / need
        used[level] = used.get(level, 0.0) + avail
        spill = next((n for n in fallback_order if n != level),
                     hier.outermost().name)
        splits[tclass] = ((level, fit), (spill, 1.0 - fit))
    if not splits:
        return p
    return Placement(p.name + "+cap", dict(p.mapping), {**p.splits, **splits})
