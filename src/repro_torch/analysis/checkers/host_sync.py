"""Checker 2 — host-sync discipline + wall-clock ban, for PyTorch.

Rule ``host-sync``: inside ``serving/``, every device->host
synchronization site must sit within a few CFG statements of a
``host_syncs`` counter update, so ``ServeStats.host_syncs`` ("device->host
round-trips taken") stays an exact count, which the fused-decode
sync-bound tests and the paper's one-sync-per-block claim both lean on.
A sync site is

* ``.cpu()`` or ``.item()`` of anything;
* ``.tolist()`` or ``.numpy()`` of a device value;
* ``int``/``float``/``bool`` of a device value;
* ``np.asarray``/``np.array`` of a device value;
* ``torch.cuda.synchronize(...)``;
* a call to a *sync helper*: a function of ``serving/`` that syncs and
  keeps no ``host_syncs`` itself (``engine._sync``). Its own sites answer
  to its callers, each call of it being a sync site.

Device values are tracked by a flow-insensitive taint pass within each
function, seeded at the results of calls into ``repro_torch.models`` and
``repro_torch.kernels`` (names imported from them, or members of a module
imported from them) and at ``self._dev(...)``, the engines' upload. A
value read off a tensor's metadata (``.shape``, ``.dtype``, ``.device``,
``len``) and the result of a pull are host values. ``np.asarray`` over
plain host data (hash digests, latency lists) is NOT a sync and is never
flagged.

``counted_sites(project)`` returns the sync sites the rule accepts, the
statements' line ranges with their functions: what a run under
``torch.cuda.set_sync_debug_mode("warn")`` may pull at.

Rule ``wall-clock``: virtual-time modules must not read the wall clock
— ``time.time``/``time.monotonic``/``datetime.now``-style calls are
banned everywhere under ``repro_torch/`` except ``launch/dryrun.py`` (the
compile-latency harness, which measures real wall time on purpose) and
``launch/ranks.py`` (the rank launcher: the order in which processes
failed, and the deadline of a join, are real time across processes, not
any serve's virtual time). ``time.perf_counter`` stays legal: it is the
measured-kernel-wall basis the virtual clock is built FROM (DESIGN.md
SS13).
"""
from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.cfg import build_cfg
from repro_torch.analysis.core import (Finding, FunctionInfo, ModuleInfo,
                                       Project, attr_chain, stmt_calls)

RULE = "host-sync"
WALL_RULE = "wall-clock"
SCOPE = "repro_torch/serving/"
WALL_ALLOWLIST = ("repro_torch/launch/dryrun.py",
                  "repro_torch/launch/ranks.py")
# packages whose call results are device values
DEVICE_PACKAGES = ("repro_torch.models", "repro_torch.kernels")

# how many CFG statements away an increment may sit from its sync site
ADJACENCY = 12

_WALL_BANNED: Tuple[Tuple[str, ...], ...] = (
    ("time", "time"), ("time", "monotonic"), ("time", "monotonic_ns"),
    ("time", "localtime"), ("time", "gmtime"), ("time", "ctime"),
    ("time", "strftime"), ("datetime", "now"), ("datetime", "utcnow"),
    ("datetime", "today"), ("date", "today"),
)
# tensor metadata: reading it takes no sync and gives a host value
META_ATTRS = frozenset({"shape", "dtype", "device", "ndim", "is_cuda",
                        "is_cpu", "layout", "requires_grad"})
META_CALLS = frozenset({"size", "dim", "numel", "data_ptr", "stride",
                        "element_size", "is_contiguous", "get_device",
                        "len", "isinstance", "type"})
# methods that pull a device value to the host: always, or of a device value
ALWAYS_PULLS = frozenset({"cpu", "item"})
DEVICE_PULLS = frozenset({"tolist", "numpy"})
SCALAR_CASTS = frozenset({"int", "float", "bool"})


def callee_name(call: ast.Call) -> str:
    """The called name: ``f`` of ``f(..)``, ``m`` of ``<any expr>.m(..)``
    (``call_name`` gives "" where the receiver is not a name chain, as in
    ``torch.cat(..).cpu()``)."""
    if isinstance(call.func, ast.Attribute):
        return call.func.attr
    return call.func.id if isinstance(call.func, ast.Name) else ""


def is_np_asarray(call: ast.Call) -> bool:
    chain = attr_chain(call.func)
    return (len(chain) == 2 and chain[0] in ("np", "numpy")
            and chain[1] in ("asarray", "array"))


def is_cuda_synchronize(call: ast.Call) -> bool:
    chain = attr_chain(call.func)
    return chain[-3:] == ["torch", "cuda", "synchronize"] or chain[-2:] == [
        "cuda", "synchronize"]


def device_names(mod: ModuleInfo) -> Set[str]:
    """The names ``mod`` imports from ``DEVICE_PACKAGES``: ``from
    repro_torch.models import decode_step`` gives ``decode_step`` (a call
    of it is a call into the package), ``from repro_torch.kernels import
    sharded as ksh`` gives ``ksh`` (so does a call of its members)."""
    names: Set[str] = set()
    for node in mod.tree.body:
        if isinstance(node, ast.ImportFrom) and node.module and any(
                node.module == p or node.module.startswith(p + ".")
                for p in DEVICE_PACKAGES):
            names |= {a.asname or a.name for a in node.names}
    return names


def _bound_names(targets: List[ast.expr]) -> List[str]:
    """The names an assignment to ``targets`` binds (``a``, ``a, *b``);
    an attribute or subscript target binds none."""
    out: List[str] = []
    for t in targets:
        if isinstance(t, ast.Name):
            out.append(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            out.extend(_bound_names(list(t.elts)))
        elif isinstance(t, ast.Starred):
            out.extend(_bound_names([t.value]))
    return out


class Taint:
    """Flow-insensitive device-value taint within one function. ``seeds``
    decides which calls return device values; ``names`` starts with the
    function's known device parameters."""

    def __init__(self, is_seed, names: Optional[Set[str]] = None):
        self.is_seed = is_seed
        self.names: Set[str] = set(names or ())

    def device(self, expr: Optional[ast.expr]) -> bool:
        if expr is None:
            return False
        if isinstance(expr, ast.Call):
            name = callee_name(expr)
            if self.is_seed(expr):
                return True
            if name in META_CALLS or name in SCALAR_CASTS \
                    or name in ALWAYS_PULLS or name in DEVICE_PULLS \
                    or is_np_asarray(expr):
                return False          # metadata, or the pull's host result
            if isinstance(expr.func, ast.Attribute) \
                    and self.device(expr.func.value):
                return True           # a method of a device value
            return any(self.device(a) for a in expr.args) or any(
                kw.value is not None and self.device(kw.value)
                for kw in expr.keywords)
        if isinstance(expr, ast.Attribute):
            return expr.attr not in META_ATTRS and self.device(expr.value)
        if isinstance(expr, ast.Name):
            return expr.id in self.names
        if isinstance(expr, ast.Lambda):
            return False
        return any(self.device(c) for c in ast.iter_child_nodes(expr)
                   if isinstance(c, ast.expr))

    def run(self, fn: ast.AST) -> None:
        flows = _flows(fn)
        changed = True
        while changed:
            changed = False
            for val, bound in flows:
                if bound - self.names and self.device(val):
                    self.names |= bound
                    changed = True


_FLOWS: Dict[int, Tuple[ast.AST, List[Tuple[ast.expr, Set[str]]]]] = {}


def _flows(fn: ast.AST) -> List[Tuple[ast.expr, Set[str]]]:
    """(value, names it binds) of every assignment and loop in ``fn``."""
    hit = _FLOWS.get(id(fn))
    if hit is not None and hit[0] is fn:
        return hit[1]
    out = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            val, tgts = node.value, node.targets
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            val, tgts = node.value, [node.target]
        elif isinstance(node, (ast.For, ast.comprehension)):
            val, tgts = node.iter, [node.target]
        else:
            continue
        bound = set(_bound_names(tgts))
        if val is not None and bound:
            out.append((val, bound))
    _FLOWS[id(fn)] = (fn, out)
    return out


def sync_what(call: ast.Call, taint: Taint,
              helpers: Set[str] = frozenset()) -> Optional[str]:
    """What kind of device->host sync ``call`` is, or None."""
    chain = attr_chain(call.func)
    name = callee_name(call)
    recv = call.func.value if isinstance(call.func, ast.Attribute) else None
    if name in ALWAYS_PULLS and recv is not None:
        return f".{name}()"
    if name in DEVICE_PULLS and recv is not None and taint.device(recv):
        return f".{name}() of a device value"
    if chain == [name] and name in SCALAR_CASTS and call.args \
            and taint.device(call.args[0]):
        return f"{name}(<device value>)"
    if is_np_asarray(call) and call.args and taint.device(call.args[0]):
        return f"np.{name}(<device value>)"
    if is_cuda_synchronize(call):
        return "torch.cuda.synchronize()"
    if chain == [name] and name in helpers:
        return f"{name}() (a sync helper)"
    return None


def _serving_seed(mod: ModuleInfo):
    names = device_names(mod)

    def is_seed(call: ast.Call) -> bool:
        chain = attr_chain(call.func)
        if len(chain) in (1, 2) and chain[0] in names:
            return True
        return chain == ["self", "_dev"]
    return is_seed


def _is_increment(stmt: ast.stmt) -> bool:
    tgts: List[ast.expr] = []
    if isinstance(stmt, ast.AugAssign):
        tgts = [stmt.target]
    elif isinstance(stmt, ast.Assign):
        tgts = list(stmt.targets)
    for tgt in tgts:
        chain = attr_chain(tgt)
        if chain and chain[-1] == "host_syncs":
            return True
    return False


def _header_end(stmt: ast.stmt) -> int:
    """The last line of ``stmt``'s own part: a compound statement's
    header, any other statement whole."""
    if isinstance(stmt, (ast.If, ast.While)):
        return stmt.test.end_lineno
    if isinstance(stmt, (ast.For, ast.AsyncFor)):
        return stmt.iter.end_lineno
    if isinstance(stmt, (ast.With, ast.AsyncWith)):
        return stmt.items[-1].context_expr.end_lineno
    if isinstance(stmt, (ast.Try, ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
        return stmt.lineno
    return stmt.end_lineno


@dataclass(frozen=True)
class SyncSite:
    """One sync statement of ``serving/``: the file, its first and last
    line, the enclosing function, what syncs, and whether a ``host_syncs``
    update lies within ``ADJACENCY`` statements."""
    path: str
    line: int
    end_line: int
    qualname: str
    what: str
    counted: bool


def _function_sites(mod: ModuleInfo, info: FunctionInfo,
                    helpers: Set[str]) -> List[SyncSite]:
    fn = info.node
    taint = Taint(_serving_seed(mod))
    taint.run(fn)
    cfg = build_cfg(fn)
    sync_nodes: List[Tuple[int, ast.stmt, str]] = []
    incr_nodes: Set[int] = set()
    for node in cfg.stmt_nodes():
        if _is_increment(node.stmt):
            incr_nodes.add(node.idx)
        for c in stmt_calls(node.stmt):
            what = sync_what(c, taint, helpers)
            if what is not None:
                sync_nodes.append((node.idx, node.stmt, what))

    out: List[SyncSite] = []
    for idx, stmt, what in sync_nodes:
        found = idx in incr_nodes
        # undirected BFS: an increment within ADJACENCY statements in
        # either flow direction counts as "adjacent"
        seen = {idx}
        frontier = {idx}
        for _ in range(ADJACENCY if not found else 0):
            nxt = set()
            for u in frontier:
                for v, _k in cfg.succ[u]:
                    nxt.add(v)
                for v, _k in cfg.pred[u]:
                    nxt.add(v)
            nxt -= seen
            if nxt & incr_nodes:
                found = True
                break
            seen |= nxt
            frontier = nxt
            if not frontier:
                break
        out.append(SyncSite(mod.rel, stmt.lineno, _header_end(stmt),
                            info.qualname, what, found))
    return out


def _helpers(mods: List[ModuleInfo]) -> Dict[str, Set[str]]:
    """{module rel: names of its module-level sync helpers}."""
    out: Dict[str, Set[str]] = {}
    for mod in mods:
        taint = Taint(lambda c: False)
        for node in mod.tree.body:
            if not isinstance(node, ast.FunctionDef):
                continue
            if any(_is_increment(s) for s in ast.walk(node)
                   if isinstance(s, ast.stmt)):
                continue
            if any(sync_what(c, taint) for c in ast.walk(node)
                   if isinstance(c, ast.Call)):
                out.setdefault(mod.rel, set()).add(node.name)
    return out


def sync_sites(project: Project) -> List[SyncSite]:
    """Every sync site of ``serving/`` but the sync helpers' own."""
    mods = project.in_dir(SCOPE)
    helpers = _helpers(mods)
    out: List[SyncSite] = []
    for mod in mods:
        own = helpers.get(mod.rel, set())
        for info in mod.functions:
            if info.cls is None and info.qualname in own:
                continue
            out.extend(_function_sites(mod, info, own))
    return out


def counted_sites(project: Project) -> List[SyncSite]:
    """The sync sites the rule accepts: counted, or allowed by a pragma."""
    out = []
    for s in sync_sites(project):
        mod = project.module(s.path)
        if s.counted or (mod is not None and mod.allowed(RULE, s.line)):
            out.append(s)
    return out


def innermost_stmt(mod: ModuleInfo, line: int) -> Optional[ast.stmt]:
    """The statement of ``mod`` with the shortest span holding ``line``."""
    best = None
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.stmt) and node.lineno <= line <= (
                node.end_lineno or node.lineno):
            if best is None or (node.end_lineno - node.lineno
                                < best.end_lineno - best.lineno):
                best = node
    return best


def sync_class(mod: ModuleInfo, line: int) -> str:
    """How the statement of ``mod`` at ``line`` may block on the device:
    "pull" (device to host: ``.cpu()``, ``.item()``), "upload" (host to
    device: ``torch.as_tensor``/``torch.tensor``, ``.to``, ``.cuda``, which
    may wrap an ``np.asarray`` of host data), "pull" again for a
    ``.tolist()``, ``.numpy()``, ``int``/``float``/``bool`` or
    ``np.asarray`` with no upload beside it, else "other" (a synchronizing
    op: a nonzero, a masked select...). Reads the code only: for a site a
    run saw sync."""
    stmt = innermost_stmt(mod, line)
    calls = stmt_calls(stmt) if stmt is not None else []
    names = {callee_name(c) for c in calls}
    if names & ALWAYS_PULLS:
        return "pull"
    if names & {"as_tensor", "tensor", "to", "cuda"}:
        return "upload"
    if names & (DEVICE_PULLS | SCALAR_CASTS) or any(
            is_np_asarray(c) for c in calls):
        return "pull"
    return "other"


def _wall_clock(project: Project) -> List[Finding]:
    out: List[Finding] = []
    for mod in project.modules:
        if mod.rel in WALL_ALLOWLIST:
            continue
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            chain = tuple(attr_chain(node.func))
            if any(chain[-len(b):] == b for b in _WALL_BANNED if chain):
                qual = "<module>"
                out.append(Finding(
                    WALL_RULE, mod.rel, node.lineno, qual,
                    f"wall-clock call {'.'.join(chain)}() in a "
                    f"virtual-time module (allowlist: "
                    f"{', '.join(WALL_ALLOWLIST)})"))
    return out


def check(project: Project) -> List[Finding]:
    out: List[Finding] = []
    for s in sync_sites(project):
        if not s.counted:
            out.append(Finding(
                RULE, s.path, s.line, s.qualname,
                f"device sync {s.what} has no host_syncs accounting within "
                f"{ADJACENCY} statements"))
    out.extend(_wall_clock(project))
    return out
