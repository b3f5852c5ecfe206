"""Shared latency-statistics helpers (DESIGN.md SS15).

One percentile implementation for every consumer — ``ServeStats`` in the
engine, the benchmark JSON writers, and the trace layer's SLO report —
so the p50/p95 a benchmark records is bit-identical to the one the
engine prints. Before this module the logic lived twice (``ServeStats
._pct`` and inline rounding in ``benchmarks/serve_bench.py``) and could
drift independently.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def percentile(xs: Sequence[float], q: float) -> float:
    """``np.percentile`` with the empty-list convention the serving
    metrics use: no samples -> 0.0 (a run that emitted nothing has no
    latency, not a NaN)."""
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile q must be in [0, 100], got {q}")
    xs = list(xs)
    return float(np.percentile(np.asarray(xs), q)) if xs else 0.0


def pct_ms(xs: Sequence[float], q: float, ndigits: int = 3) -> float:
    """Percentile of second-valued samples, reported in milliseconds
    rounded for JSON emission (the benchmark writers' convention)."""
    return round(percentile(xs, q) * 1e3, ndigits)


def latency_summary_ms(xs: Sequence[float], *,
                       ndigits: int = 3) -> Dict[str, float]:
    """The standard latency block the benchmark JSON sections share:
    p50/p95/mean/max over second-valued samples, in milliseconds."""
    xs = list(xs)
    mean = float(np.mean(xs)) if xs else 0.0
    mx = float(np.max(xs)) if xs else 0.0
    return {
        "p50_ms": pct_ms(xs, 50, ndigits),
        "p95_ms": pct_ms(xs, 95, ndigits),
        "mean_ms": round(mean * 1e3, ndigits),
        "max_ms": round(mx * 1e3, ndigits),
        "n": len(xs),
    }
