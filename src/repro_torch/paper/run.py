"""Runner harness: one module per paper table/figure, as the reference's
``benchmarks/run.py``.

Prints ``name,us_per_call,derived`` CSV. ``us_per_call`` times the analytical
evaluation itself (the paper's artifact is the model, so its evaluation cost
is the honest per-call number); ``derived`` carries the reproduced claim.
``roofline_h100`` is the reference's ``roofline_tpu`` on the H100: it
reads the port's dry-run records (``artifacts/dryrun_torch``).

Run: PYTHONPATH=src python -m repro_torch.paper.run [--only fig1,table1]
"""
from __future__ import annotations

import argparse
import importlib
import time

from repro_torch.paper import common

MODULES = ("table1", "fig1", "fig2", "fig3", "fig4", "beyond_gpu_tiers",
           "roofline_h100")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="", help="comma-separated module names")
    args = ap.parse_args(argv)
    only = set(filter(None, args.only.split(",")))

    for name in MODULES:
        if only and name not in only:
            continue
        mod = importlib.import_module(f"repro_torch.paper.{name}")
        t0 = time.perf_counter()
        try:
            derived = mod.run(common.emit)
        except Exception as e:  # keep the harness alive; report the failure
            derived = f"ERROR:{type(e).__name__}:{e}"
        us = (time.perf_counter() - t0) * 1e6
        common.emit(f"{name}.total", us, derived)
    common.flush()


if __name__ == "__main__":
    main()
