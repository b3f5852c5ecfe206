"""The runners' ``name,us_per_call,derived`` CSV (``emit``/``flush`` of the
reference's ``benchmarks/common.py``) and the sweeps' per-cell goodput
summary (its ``goodput_summary``)."""
from __future__ import annotations

from typing import Dict, List, Tuple

ROWS: List[Tuple[str, float, str]] = []


def emit(row_name: str, us: float, derived: str) -> None:
    ROWS.append((row_name, us, derived))


def flush() -> None:
    print("name,us_per_call,derived")
    for name, us, derived in ROWS:
        print(f"{name},{us:.1f},{derived}")
    ROWS.clear()


def goodput_summary(report: dict) -> dict:
    """Compact per-cell form of ``TraceRecorder.slo_report`` for sweep
    grids: goodput + how many violators each phase is blamed for."""
    blame: Dict[str, int] = {}
    for v in report["violators"]:
        blame[v["blame"]] = blame.get(v["blame"], 0) + 1
    return {"goodput_frac": report["goodput_frac"],
            "n_met_slo": report["n_met_slo"],
            "n_requests": report["n_requests"],
            "violator_blame": blame}


# the page counters a serve's schedule fixes when its prefill and decode
# share one stream (``overlap=False``): compared between the card and the
# CPU twin of the same requests, and with the reference engine's. Left
# out, since they follow the measured step times: prefetch hits and
# misses (a hit is a fetch landed by the block's virtual start, a sum of
# step times), and which tier each touch read (the total is kept). The
# lookahead prefetch (``PagedKVManager.prefetch_seqs``) runs its extra
# rebalance round only when the fetch channel is idle at the block's
# virtual start, and that round's EMA pass can promote a page into the
# chiplet a round earlier. The same round could in principle move the
# other counters too; across the sweeps' cells with step times scaled
# from 0.03x to 1000x only the per-tier touches moved.
SCHEDULE_COUNTERS = ("pages_spilled", "pages_fetched", "peak_fast_pages",
                     "chiplet_promotions", "chiplet_demotions",
                     "clean_demotions", "host_syncs")


def schedule_counters(stats, page_nbytes: float) -> dict:
    """``SCHEDULE_COUNTERS`` of a ``ServeStats``, the total of its
    ``tier_touches`` and its per-channel traffic in pages."""
    out = {k: getattr(stats, k) for k in SCHEDULE_COUNTERS}
    out["tier_touches"] = sum(stats.tier_touches.values())
    out["channel_pages"] = {ch: nb / page_nbytes for ch, nb in
                            sorted(stats.channel_bytes.items())}
    return out
