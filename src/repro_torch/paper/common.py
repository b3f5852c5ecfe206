"""The runners' ``name,us_per_call,derived`` CSV (``emit``/``flush`` of the
reference's ``benchmarks/common.py``)."""
from __future__ import annotations

from typing import List, Tuple

ROWS: List[Tuple[str, float, str]] = []


def emit(row_name: str, us: float, derived: str) -> None:
    ROWS.append((row_name, us, derived))


def flush() -> None:
    print("name,us_per_call,derived")
    for name, us, derived in ROWS:
        print(f"{name},{us:.1f},{derived}")
    ROWS.clear()
