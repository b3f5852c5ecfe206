"""The H100 roofline table from the dry run's records (the reference's
``benchmarks/roofline_tpu.py``, on the port).

Reads ``artifacts/dryrun_torch/*.json``, written by
``python -m repro_torch.launch.dryrun``, and reports the three roofline
terms of every (arch x shape x mesh) cell priced on the H100
(``core/h100_roofline.py``): compute, memory and collective seconds a
rank, the bottleneck, and the step's lower bound. Skipped cells, errors
and tagged variants are not rows. Skips quietly when there are no
records yet (run the dry run first).

Run: PYTHONPATH=src python -m repro_torch.paper.roofline_h100 [--art DIR]
     [--markdown]   (every record as a table row: bytes a rank, bottleneck,
                     step bound, trace seconds, or its skip reason)
     [--grid]       (the production grid, a row an arch and a column a
                     shape: peak bytes a rank, bottleneck and step bound,
                     16x16 / 2x16x16)
"""
from __future__ import annotations

import argparse
import json
import pathlib

from repro_torch.paper import common

ART = pathlib.Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"


def run(emit, art=None) -> str:
    art = pathlib.Path(art or ART)
    if not art.exists():
        return ("no dry-run records (run python -m repro_torch.launch.dryrun "
                "first)")
    n, worst = 0, ("", 0.0)
    for p in sorted(art.glob("*.json")):
        rec = json.loads(p.read_text())
        if "roofline" not in rec or rec.get("tag"):
            continue
        r = rec["roofline"]
        emit(f"roofline.{p.stem}", 0.0,
             f"compute={r['compute_s']:.2e}s memory={r['memory_s']:.2e}s "
             f"collective={r['collective_s']:.2e}s bott={r['bottleneck']} "
             f"bound={r['step_time_lower_bound_s']:.2e}s "
             f"useful={r['model_flops_ratio']:.2f}")
        n += 1
        frac = r.get("roofline_fraction", 0.0)
        if worst[0] == "" or frac < worst[1]:
            worst = (p.stem, frac)
    return f"{n} cells; worst_roofline_fraction={worst[0]}:{worst[1]:.2f}"


def table(art=None) -> str:
    """Every record as a markdown row: the cell, its bytes a rank
    (argument, peak), bottleneck and step bound on the H100, the trace's
    seconds, or its skip reason or error."""
    lines = ["| arch | shape | mesh | argument GB | peak GB | bottleneck | "
             "bound s | trace s |", "| --- | --- | --- | --- | --- | --- | "
             "--- | --- |"]
    for p in sorted(pathlib.Path(art or ART).glob("*.json")):
        rec = json.loads(p.read_text())
        if rec.get("tag"):
            continue
        head = f"| {rec['arch']} | {rec['shape']} | {rec['mesh']} |"
        if "roofline" not in rec:
            why = rec.get("skipped") or f"error: {rec.get('error')}"
            lines.append(f"{head} {why} | | | | |")
            continue
        m, r = rec["memory"], rec["roofline"]
        lines.append(f"{head} {m['argument_bytes'] / 1e9:.3f} | "
                     f"{m['peak_bytes'] / 1e9:.3f} | {r['bottleneck']} | "
                     f"{r['step_time_lower_bound_s']:.4g} | "
                     f"{rec['compile_s']} |")
    return "\n".join(lines)


GRID_MESHES = ("pod16x16", "pod2x16x16")
_SHORT = {"memory": "mem", "compute": "cmp", "collective": "coll"}


def grid(art=None) -> str:
    """The production grid as markdown: a row an arch (in the records'
    order of first appearance), a column a shape, each cell "peak GB;
    bottleneck; bound s" on 16x16 / 2x16x16, "skipped" for a skipped
    cell, "missing" or "error" where a record is absent or failed."""
    recs = {}
    for p in sorted(pathlib.Path(art or ART).glob("*.json")):
        rec = json.loads(p.read_text())
        if not rec.get("tag") and rec["mesh"] in GRID_MESHES:
            recs[(rec["arch"], rec["shape"], rec["mesh"])] = rec
    archs = list(dict.fromkeys(a for a, _, _ in recs))
    shapes = list(dict.fromkeys(s for _, s, _ in recs))
    lines = ["| arch | " + " | ".join(shapes) + " |",
             "| --- |" + " --- |" * len(shapes)]
    for a in archs:
        cells = []
        for s in shapes:
            rs = [recs.get((a, s, m)) for m in GRID_MESHES]
            if any(r is None for r in rs):
                cells.append("missing")
            elif all("skipped" in r for r in rs):
                cells.append("skipped")
            elif any("roofline" not in r for r in rs):
                cells.append("error")
            else:
                bott = list(dict.fromkeys(
                    _SHORT[r["roofline"]["bottleneck"]] for r in rs))
                cells.append(
                    " / ".join(f"{r['memory']['peak_bytes'] / 1e9:.3g}"
                               for r in rs) + " GB; " + "/".join(bott)
                    + "; " + " / ".join(
                        f"{r['roofline']['step_time_lower_bound_s']:.3g}"
                        for r in rs) + " s")
        lines.append(f"| {a} | " + " | ".join(cells) + " |")
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--art", default=None,
                    help="the dry run's records (default: artifacts/"
                    "dryrun_torch)")
    ap.add_argument("--markdown", action="store_true",
                    help="print every record as a markdown table instead")
    ap.add_argument("--grid", action="store_true",
                    help="print the production grid (arch x shape) instead")
    args = ap.parse_args(argv)
    if args.grid:
        print(grid(args.art))
        return
    if args.markdown:
        print(table(args.art))
        return
    derived = run(common.emit, args.art)
    common.emit("roofline_h100.total", 0.0, derived)
    common.flush()


if __name__ == "__main__":
    main()
