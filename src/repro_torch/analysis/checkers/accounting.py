"""Checker 4 — accounting completeness (rules ``accounting``,
``channel-vocab``).

``ServeStats`` is the serving stack's ledger; ``trace.reconcile()`` is
its audit. This checker closes the loop statically:

* every ``ServeStats`` field must be WRITTEN by some ``serving/``
  module (a field nothing writes is dead weight that silently reports
  zero), and
* every field must either appear in the ``trace.reconcile(...)`` call
  (the audited set) or carry an entry in the EXEMPT table below, whose
  justification documents why the trace cannot cross-check it. A stale
  exemption — for a field that no longer exists or that became
  reconciled — is itself a finding, so the table cannot rot.

``channel-vocab``: ``channel_bytes`` keys come from the fixed
``"src->dst"`` vocabulary in :mod:`repro.serving.channels`. Any
``"a->b"`` string literal in a serving module must be a known label, and
f-strings must not build labels inline — they must route through
``channels.make_label`` so the runtime validates direction.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, List, Set

from repro_torch.analysis.core import (Finding, ModuleInfo, Project,
                                       attr_chain, call_name, call_recv)
from repro_torch.serving.channels import CHANNEL_LABELS

RULE = "accounting"
VOCAB_RULE = "channel-vocab"
SCOPE = "repro_torch/serving/"
ENGINE_REL = "repro_torch/serving/engine.py"
CHANNELS_REL = "repro_torch/serving/channels.py"

_LABEL_RE = re.compile(r"^[a-z0-9_]+->[a-z0-9_]+$")

# Fields the trace genuinely cannot audit, with the reason why. The
# reconciled set is parsed from the live trace.reconcile(...) call, so
# a field that later joins the audit flips its entry here to "stale".
EXEMPT: Dict[str, str] = {
    "prefill_s": "phase wall time; the trace's per-span times are "
                 "derived FROM it, a cross-check would be circular",
    "decode_s": "phase wall time; same circularity as prefill_s",
    "serve_s": "stream-clock makespan; finalize() consumes it as input",
    "requests": "workload size, an input not a measurement",
    "decode_steps": "device micro-step count; no trace event per step "
                    "by design (one span per fused block)",
    "preemptions": "scheduler event count; preemption spans carry no "
                   "aggregate to diff against",
    "prefill_tokens_computed": "chunk arithmetic audited by "
                               "test_prefix_cache token-count asserts",
    "cached_prefix_tokens": "prefix-cache hit accounting, audited "
                            "dynamically against kv.dedup_tokens",
    "pages_deduped": "kv-manager counter folded 1:1 into stats",
    "cow_copies": "kv-manager counter folded 1:1 into stats",
    "peak_pages_used": "a max, not a flow; cannot be conserved",
    "prefill_compiles": "compile-cache size, host-side observability",
    "host_syncs": "host round-trip count, enforced statically by the "
                  "host-sync rule and by sync-bound tests",
    "decode_compiles": "compile-cache size, host-side observability",
    "spill_bytes": "conserved against channel_bytes['ddr->hbs'], which "
                   "IS reconciled; a second check would double-count",
    "fetch_bytes": "conserved against channel_bytes['hbs->ddr'] (same)",
    "pages_spilled": "kv-manager counter folded 1:1 into stats",
    "pages_fetched": "kv-manager counter folded 1:1 into stats",
    "peak_fast_pages": "a max, not a flow; cannot be conserved",
    "prefetch_hits": "hit/miss split audited by tier-residency tests",
    "prefetch_misses": "hit/miss split audited by tier-residency tests",
    "clean_demotions": "free residency flips move no bytes, so the "
                       "byte-conservation audit cannot see them",
    "chiplet_promotions": "conserved against channel_bytes"
                          "['ddr->chiplet'] per-page-size",
    "chiplet_demotions": "conserved against channel_bytes"
                         "['chiplet->ddr'] per-page-size",
    "tier_touches": "EMA inputs; rates derived from them are asserted "
                    "in chiplet tests, totals are not conserved",
    "stall_saved_s": "counterfactual (barrier minus pipelined); only "
                     "the real stall_s is observable in the trace",
    "kv_split_at_peak": "snapshot at peak occupancy, not a flow",
    "draft_proposed": "spec accounting audited by acceptance-rate "
                      "asserts in test_spec_decode",
    "draft_accepted": "spec accounting audited by acceptance-rate "
                      "asserts in test_spec_decode",
    "spec_blocks": "verify-pass count; one spec_verify span each, but "
                   "spans are not counted by reconcile",
}


def _servestats_fields(engine: ModuleInfo) -> List[str]:
    for node in engine.tree.body:
        if isinstance(node, ast.ClassDef) and node.name == "ServeStats":
            return [s.target.id for s in node.body
                    if isinstance(s, ast.AnnAssign)
                    and isinstance(s.target, ast.Name)]
    return []


def _written_fields(mods: List[ModuleInfo], fields: Set[str]) -> Set[str]:
    written: Set[str] = set()
    for mod in mods:
        for node in ast.walk(mod.tree):
            tgts: List[ast.AST] = []
            if isinstance(node, ast.Assign):
                tgts = list(node.targets)
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                tgts = [node.target]
            elif isinstance(node, ast.Call):
                # list/dict growth: stats.ttft.append(...), .update(...)
                chain = attr_chain(node.func)
                if chain and chain[-1] in ("append", "extend", "update"):
                    written |= set(chain) & fields
                continue
            for tgt in tgts:
                for n in ast.walk(tgt):
                    if isinstance(n, ast.Attribute) and n.attr in fields:
                        written.add(n.attr)
    return written


def _reconciled_fields(engine: ModuleInfo, fields: Set[str]) -> Set[str]:
    out: Set[str] = set()
    for node in ast.walk(engine.tree):
        if isinstance(node, ast.Call) and call_name(node) == "reconcile" \
                and call_recv(node) == "trace":
            for kw in node.keywords:
                if kw.arg in fields:
                    out.add(kw.arg)
            for n in ast.walk(node):
                if isinstance(n, ast.Attribute) and n.attr in fields:
                    out.add(n.attr)
    return out


def _vocab_findings(mods: List[ModuleInfo]) -> List[Finding]:
    out: List[Finding] = []
    for mod in mods:
        if mod.rel == CHANNELS_REL:
            continue
        docstrings = set()
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.Module, ast.ClassDef,
                                 ast.FunctionDef, ast.AsyncFunctionDef)):
                body = getattr(node, "body", [])
                if body and isinstance(body[0], ast.Expr) and isinstance(
                        body[0].value, ast.Constant):
                    docstrings.add(id(body[0].value))
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Constant) \
                    and isinstance(node.value, str) \
                    and id(node) not in docstrings \
                    and _LABEL_RE.match(node.value):
                if node.value not in CHANNEL_LABELS:
                    out.append(Finding(
                        VOCAB_RULE, mod.rel, node.lineno, "<module>",
                        f"channel label {node.value!r} is not in the "
                        f"fixed vocabulary "
                        f"({', '.join(CHANNEL_LABELS)})"))
            elif isinstance(node, ast.JoinedStr):
                for part in node.values:
                    if isinstance(part, ast.Constant) \
                            and isinstance(part.value, str) \
                            and "->" in part.value:
                        out.append(Finding(
                            VOCAB_RULE, mod.rel, node.lineno, "<module>",
                            "channel label built inline with an "
                            "f-string; route it through "
                            "channels.make_label so direction is "
                            "validated"))
                        break
    return out


def check(project: Project) -> List[Finding]:
    engine = project.module(ENGINE_REL)
    serving = project.in_dir(SCOPE)
    out: List[Finding] = []
    if engine is not None:
        fields = _servestats_fields(engine)
        fieldset = set(fields)
        if fields:
            written = _written_fields(serving, fieldset)
            reconciled = _reconciled_fields(engine, fieldset)
            cls_line = next(
                (n.lineno for n in engine.tree.body
                 if isinstance(n, ast.ClassDef)
                 and n.name == "ServeStats"), 1)
            for f in fields:
                if f not in written:
                    out.append(Finding(
                        RULE, ENGINE_REL, cls_line, "ServeStats",
                        f"field '{f}' is never written by any serving "
                        f"module"))
                if f not in reconciled and f not in EXEMPT:
                    out.append(Finding(
                        RULE, ENGINE_REL, cls_line, "ServeStats",
                        f"field '{f}' is neither reconciled in "
                        f"trace.reconcile() nor exempted (add it to the "
                        f"audit, or justify an exemption in "
                        f"checkers/accounting.py)"))
            for f, why in EXEMPT.items():
                if f not in fieldset:
                    out.append(Finding(
                        RULE, ENGINE_REL, cls_line, "ServeStats",
                        f"stale exemption: '{f}' is not a ServeStats "
                        f"field"))
                elif f in reconciled:
                    out.append(Finding(
                        RULE, ENGINE_REL, cls_line, "ServeStats",
                        f"stale exemption: '{f}' is reconciled now — "
                        f"drop the exemption"))
                elif not why.strip():
                    out.append(Finding(
                        RULE, ENGINE_REL, cls_line, "ServeStats",
                        f"exemption for '{f}' has no justification"))
    out.extend(_vocab_findings(serving))
    return out
