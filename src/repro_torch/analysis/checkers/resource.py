"""Checker 1 — resource pairing (rule ``resource-pairing``).

Every acquire-style call in ``serving/`` must be paired with a release,
checked on the function's CFG:

* ``all_paths`` pairs (the residency plan/charge bracket, whose contract
  is "every plan must be charged exactly once"): a release must lie on
  EVERY path from the acquire to the normal function exit — including
  paths through exception handlers (a handler that swallows the
  exception between plan and charge leaks the plan). Paths that escape
  via an uncaught raise are exempt: the serve aborts wholesale.
* ``reach`` pairs (reservations, allocations, trace request spans,
  stream start/commit): a release must be *reachable* from the acquire
  within the function. Ownership commonly outlives one function, so two
  structural exemptions apply before a finding is raised:

  - *conduit*: the acquired value is returned to the caller (directly or
    via a name that reaches a ``return``) — ownership transfers up.
  - *class owner*: the enclosing class defines or calls a matching
    release somewhere (the resource parks in instance state; e.g. the
    scheduler's ``admit`` allocates, ``retire``/``preempt_one`` free).

  A module whose functions acquire but that contains NO release anywhere
  still gets a finding — the class-owner exemption never silently
  approves a leak-only type.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Callable, FrozenSet, List, Set, Tuple

from repro_torch.analysis.cfg import build_cfg
from repro_torch.analysis.core import (Finding, FunctionInfo,
                                       ModuleInfo, Project, call_name,
                                       call_recv, stmt_calls)

RULE = "resource-pairing"
SCOPE = "repro_torch/serving/"


def _any_recv(_: str) -> bool:
    return True


def _stream_recv(recv: str) -> bool:
    return recv.endswith("stream")


@dataclass(frozen=True)
class Pair:
    name: str
    acquire: FrozenSet[str]
    release: FrozenSet[str]
    mode: str                                  # "all_paths" | "reach"
    acquire_recv: Callable[[str], bool] = _any_recv
    release_recv: Callable[[str], bool] = _any_recv


PAIRS: Tuple[Pair, ...] = (
    # ResidencyPlan bracket: "Every plan must be charged exactly once"
    # (kv_manager.ResidencyPlan). stall_plan/stall_charge are the
    # engine's closures over the same calls.
    Pair("residency-plan",
         acquire=frozenset({"plan_residency", "stall_plan"}),
         release=frozenset({"charge_residency", "stall_charge",
                            "_issue_fetch"}),
         mode="all_paths"),
    # lookahead page reservations roll forward (commit) or back (release)
    Pair("kv-reservation",
         acquire=frozenset({"reserve_ahead", "reserve_lookahead"}),
         release=frozenset({"commit_tokens", "commit_speculative",
                            "release_reserved", "free_seq", "retire",
                            "preempt_one", "drop"}),
         mode="reach"),
    # page allocations are freed when the sequence leaves the pool
    Pair("kv-allocation",
         acquire=frozenset({"allocate", "allocate_shared"}),
         release=frozenset({"free_seq", "retire", "preempt_one", "drop"}),
         mode="reach",
         acquire_recv=lambda r: r in ("kv", "self")),
    # every trace request span opened by submit() is closed by retire()
    # (or the trace is finalized, which audits stragglers)
    Pair("trace-request-span",
         acquire=frozenset({"submit"}),
         release=frozenset({"retire", "finalize"}),
         mode="reach",
         acquire_recv=lambda r: r == "trace"),
    # a virtual-stream op that starts must commit its duration
    Pair("stream-span",
         acquire=frozenset({"start"}),
         release=frozenset({"commit"}),
         mode="reach",
         acquire_recv=_stream_recv,
         release_recv=_stream_recv),
)


def _pair_calls(stmt: ast.stmt, names: FrozenSet[str],
                recv_ok: Callable[[str], bool]) -> List[ast.Call]:
    return [c for c in stmt_calls(stmt)
            if call_name(c) in names and recv_ok(call_recv(c))]


def _returned_names(fn: ast.FunctionDef) -> Set[str]:
    """Names that flow into a return statement of ``fn`` (one hop)."""
    out: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Return) and node.value is not None:
            for n in ast.walk(node.value):
                if isinstance(n, ast.Name):
                    out.add(n.id)
    return out


def _is_conduit(fn: ast.FunctionDef, stmt: ast.stmt,
                acq_call: ast.Call) -> bool:
    """The acquired value escapes to the caller via a return."""
    if isinstance(stmt, ast.Return):
        return True
    if isinstance(stmt, ast.Assign):
        ret_names = _returned_names(fn)
        for tgt in stmt.targets:
            for n in ast.walk(tgt):
                if isinstance(n, ast.Name) and n.id in ret_names:
                    return True
    return False


def _class_releases(info: FunctionInfo, mod: ModuleInfo,
                    pair: Pair) -> bool:
    """The enclosing class (or, for module-level functions, the module)
    defines or calls one of the pair's release methods somewhere."""
    scope: ast.AST = info.cls if info.cls is not None else mod.tree
    for node in ast.walk(scope):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name in pair.release:
            return True
        if isinstance(node, ast.Call) \
                and call_name(node) in pair.release \
                and pair.release_recv(call_recv(node)):
            return True
    return False


def _check_function(mod: ModuleInfo, info: FunctionInfo,
                    pair: Pair) -> List[Finding]:
    fn = info.node
    # cheap pre-filter before building a CFG
    if not any(call_name(c) in pair.acquire for c in
               (n for n in ast.walk(fn) if isinstance(n, ast.Call))):
        return []
    cfg = build_cfg(fn)
    acquires: List[Tuple[int, ast.stmt, ast.Call]] = []
    release_nodes: Set[int] = set()
    for node in cfg.stmt_nodes():
        stmt = node.stmt
        acs = _pair_calls(stmt, pair.acquire, pair.acquire_recv)
        rels = _pair_calls(stmt, pair.release, pair.release_recv)
        if rels:
            release_nodes.add(node.idx)
        for c in acs:
            acquires.append((node.idx, stmt, c))

    out: List[Finding] = []
    for idx, stmt, call in acquires:
        if idx in release_nodes:
            continue                      # acquire+release in one stmt
        if _is_conduit(fn, stmt, call):
            continue                      # ownership returns to the caller
        succs = [v for v, _ in cfg.succ[idx]]
        if pair.mode == "all_paths":
            bad = cfg.exit in cfg.reachable(succs, blocked=release_nodes)
            if bad:
                out.append(Finding(
                    RULE, mod.rel, stmt.lineno, info.qualname,
                    f"'{call_name(call)}' ({pair.name}) can reach the "
                    f"function exit without any of "
                    f"{sorted(pair.release)} on some path "
                    f"(exception edges included)"))
        else:
            ok = bool(release_nodes & cfg.reachable(succs))
            if ok:
                continue
            if _class_releases(info, mod, pair):
                continue
            out.append(Finding(
                RULE, mod.rel, stmt.lineno, info.qualname,
                f"'{call_name(call)}' ({pair.name}) never reaches a "
                f"release ({', '.join(sorted(pair.release))}) — not "
                f"returned to the caller, and the enclosing "
                f"{'class' if info.cls else 'module'} has no release"))
    return out


def check(project: Project) -> List[Finding]:
    out: List[Finding] = []
    for mod in project.in_dir(SCOPE):
        for info in mod.functions:
            for pair in PAIRS:
                out.extend(_check_function(mod, info, pair))
    return out
