"""Canonical KV-tier DMA channel vocabulary — one table, three consumers.

The serving stack names every byte it moves with a directed ``"src->dst"``
channel label (DESIGN.md SS17): the runtime accounting in
``PagedKVManager._acct``, the per-link ``device_span`` labels the trace
records, the static analysis pass (``repro.analysis.checkers.accounting``)
that audits label literals, and ``scripts/check_trace.py --strict-vocab``
all draw from THIS module, so the vocabulary cannot drift between the
simulator, its trace artifacts, and the lint gate.

Tests build toy hierarchies with the same canonical tier names but
arbitrary capacities; ``make_label`` validates direction only when both
endpoints are canonical tiers, so synthetic names pass through.
"""
from __future__ import annotations

from typing import Tuple

# canonical tier names of the serving memory hierarchy, fastest first
# (mirrors kv_manager.DEFAULT_KV_TIERS; kv_manager imports from here)
KV_TIER_NAMES: Tuple[str, ...] = ("chiplet", "ddr", "hbs")

# Directed links the stack may charge bytes on. Migration always crosses
# ONE level boundary with DDR as the hub: chiplet<->hbs never transfer
# directly (a promotion out of HBS lands in DDR first, SS17).
CHANNEL_LABELS: Tuple[str, ...] = (
    "ddr->hbs",       # spill / dirty write-back across the HBS link
    "hbs->ddr",       # demand fetch / prefetch
    "ddr->chiplet",   # EMA hot-page promotion
    "chiplet->ddr",   # LRU demotion out of the chiplet level
)


def make_label(src: str, dst: str) -> str:
    """Build a ``"src->dst"`` channel label.

    When both endpoints are canonical tier names the pair must be a known
    link — a reversed or level-skipping label raises immediately at the
    accounting site instead of surfacing as reconcile drift later.
    """
    label = f"{src}->{dst}"
    if src in KV_TIER_NAMES and dst in KV_TIER_NAMES:
        if label not in CHANNEL_LABELS:
            raise ValueError(
                f"unknown KV channel {label!r}; known links: "
                f"{', '.join(CHANNEL_LABELS)}")
    return label


def is_canonical(label: str) -> bool:
    """True when ``label`` is in the fixed serving-channel vocabulary."""
    return label in CHANNEL_LABELS
