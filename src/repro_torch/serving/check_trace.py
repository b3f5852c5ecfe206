"""Check a serve trace written by ``--trace-out`` (the port's serve CLI or
``ServeEngine.trace.save``).

    PYTHONPATH=src python -m repro_torch.serving.check_trace \\
        [--strict-vocab] trace.json

The same checks, verdicts and exit codes as the reference's
``scripts/check_trace.py``: the document must parse as Chrome trace-event
JSON (``validate_chrome_trace``; a structural fault raises, exit 1), each
request's latency breakdown must conserve time (its ``PHASES`` seconds
sum to its end-to-end latency within 1e-6 s, else exit 1), and with
``--strict-vocab`` every DMA channel label in the trace (the ``link`` arg
of a span, the keys of ``metadata.channel_bytes``) must lie in
``CHANNEL_LABELS`` (else exit 1). Exit 0 prints one ``OK`` line with the
event counts. Reads a file only: no device.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence, Tuple

from repro_torch.serving.channels import CHANNEL_LABELS
from repro_torch.serving.trace import PHASES, validate_chrome_trace


def _trace_labels(doc: dict) -> set:
    labels = set()
    for ev in doc.get("traceEvents", []):
        link = ev.get("args", {}).get("link")
        if isinstance(link, str):
            labels.add(link)
    labels |= set(doc.get("metadata", {}).get("channel_bytes", {}))
    return labels


def _say(line: str) -> str:
    print(line)
    return line


def main(argv: Optional[Sequence[str]] = None) -> Tuple[int, str]:
    """Check one trace; returns (exit code, the line printed)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("path", help="Chrome trace-event JSON to validate")
    ap.add_argument("--strict-vocab", action="store_true",
                    help="fail on channel labels outside "
                         "repro_torch.serving.channels.CHANNEL_LABELS")
    args = ap.parse_args(argv)

    with open(args.path) as f:
        doc = json.load(f)
    counts = validate_chrome_trace(doc)
    breakdowns = doc.get("metadata", {}).get("breakdowns", {})
    worst = 0.0
    for rid, bd in breakdowns.items():
        parts = sum(bd[f"{p}_s"] for p in PHASES)
        err = abs(parts - bd["e2e_s"])
        worst = max(worst, err)
        if err > 1e-6:
            return 1, _say(f"[check_trace] FAIL: request {rid} phase sum "
                           f"{parts} != e2e {bd['e2e_s']}")

    labels = _trace_labels(doc)
    if args.strict_vocab:
        rogue = sorted(labels - set(CHANNEL_LABELS))
        if rogue:
            return 1, _say(f"[check_trace] FAIL: channel label(s) {rogue} "
                           f"not in the fixed vocabulary "
                           f"{list(CHANNEL_LABELS)} "
                           f"(repro_torch/serving/channels.py)")

    vocab_note = (f", {len(labels)} channel label(s) in vocabulary"
                  if args.strict_vocab else "")
    return 0, _say(f"[check_trace] OK: {args.path} — {counts['X']} spans, "
                   f"{counts['i']} instants, {counts['M']} metadata events, "
                   f"{len(breakdowns)} request breakdowns conserve time "
                   f"(worst drift {worst:.2e}s){vocab_note}")


if __name__ == "__main__":
    sys.exit(main()[0])
