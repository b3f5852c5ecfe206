"""Intra-procedural control-flow graphs over Python AST (DESIGN.md SS18).

One statement per node, plus three synthetic nodes: ENTRY, EXIT (normal
return / fall-off-the-end) and RAISE_EXIT (an exception escaping the
function). Edges carry a kind tag:

* ``normal``  — sequential flow
* ``true`` / ``false`` — branch edges out of ``if`` / loop heads
* ``back``    — loop back edge (body tail / ``continue`` -> head)
* ``exc``     — exception flow: every statement inside a ``try`` body
  gets an edge to each of that try's handler heads; an uncaught ``raise``
  edges to RAISE_EXIT

Modelling choices (deliberate over-approximations, kept simple because
the pairing checker only needs reachability, not exactness):

* Only explicit ``raise`` statements and try-body statements produce
  exception edges — an arbitrary call is NOT assumed to throw, otherwise
  "release on all paths including exception edges" would be
  unsatisfiable for any code that calls anything.
* ``finally`` blocks are threaded on the normal and handler exits and on
  ``return`` paths; the finally tail conservatively edges to both the
  continuation and EXIT.
* A ``while True:`` head has no false edge (the loop only exits via
  ``break``/``return``/``raise``), so code after an infinite loop is not
  treated as reachable from before it.
* ``assert`` and ``with`` are plain statements (an assert failure is a
  fatal invariant trip, not a resource-flow path we lint).
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Set, Tuple

NORMAL = "normal"
TRUE = "true"
FALSE = "false"
BACK = "back"
EXC = "exc"


@dataclass
class Node:
    idx: int
    stmt: Optional[ast.stmt]      # None for the synthetic nodes
    kind: str                     # "entry" | "exit" | "raise-exit" | "stmt"

    @property
    def line(self) -> int:
        return self.stmt.lineno if self.stmt is not None else 0

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        if self.stmt is None:
            return f"<{self.kind}>"
        return f"<n{self.idx} L{self.line} {type(self.stmt).__name__}>"


@dataclass
class CFG:
    name: str
    nodes: List[Node] = field(default_factory=list)
    succ: Dict[int, List[Tuple[int, str]]] = field(default_factory=dict)
    pred: Dict[int, List[Tuple[int, str]]] = field(default_factory=dict)
    entry: int = -1
    exit: int = -1
    raise_exit: int = -1

    # ------------------------------------------------------------------ #
    def add_node(self, stmt: Optional[ast.stmt], kind: str = "stmt") -> int:
        idx = len(self.nodes)
        self.nodes.append(Node(idx, stmt, kind))
        self.succ[idx] = []
        self.pred[idx] = []
        return idx

    def add_edge(self, u: int, v: int, kind: str = NORMAL) -> None:
        if (v, kind) not in self.succ[u]:
            self.succ[u].append((v, kind))
            self.pred[v].append((u, kind))

    @property
    def edges(self) -> List[Tuple[int, int, str]]:
        return [(u, v, k) for u, outs in self.succ.items()
                for v, k in outs]

    def stmt_nodes(self) -> List[Node]:
        return [n for n in self.nodes if n.stmt is not None]

    # ------------------------------------------------------------------ #
    def reachable(self, starts: Iterable[int],
                  blocked: Iterable[int] = ()) -> Set[int]:
        """Nodes reachable from ``starts`` without entering ``blocked``.

        Blocked nodes are neither visited nor expanded — this is the
        primitive behind the all-paths pairing check: a release-free path
        from an acquire to EXIT exists iff EXIT is reachable from the
        acquire's successors in the graph minus the release nodes.
        """
        blocked = set(blocked)
        seen: Set[int] = set()
        stack = [s for s in starts if s not in blocked]
        while stack:
            u = stack.pop()
            if u in seen:
                continue
            seen.add(u)
            for v, _ in self.succ[u]:
                if v not in seen and v not in blocked:
                    stack.append(v)
        return seen

    def iter_paths(self, max_paths: int = 20000) -> Iterator[List[int]]:
        """Enumerate maximal paths from ENTRY, each edge taken at most
        once per path (so every loop is unrolled at most one full lap per
        path and the walk always terminates). A path ends at EXIT,
        RAISE_EXIT, or a node whose out-edges are all already used."""
        yielded = 0
        # stack entries: (path, used-edge set)
        stack: List[Tuple[List[int], frozenset]] = [
            ([self.entry], frozenset())]
        while stack and yielded < max_paths:
            path, used = stack.pop()
            u = path[-1]
            nxt = [(v, k) for v, k in self.succ[u]
                   if (u, v, k) not in used]
            if not nxt:
                yielded += 1
                yield path
                continue
            for v, k in reversed(nxt):
                stack.append((path + [v], used | {(u, v, k)}))


class _Builder:
    """Recursive-descent CFG construction.

    A *frontier* is the set of (node, edge-kind) pairs whose edges are
    still dangling and will attach to whatever node comes next.
    """

    def __init__(self, name: str):
        self.cfg = CFG(name)
        self.cfg.entry = self.cfg.add_node(None, "entry")
        self.cfg.exit = self.cfg.add_node(None, "exit")
        self.cfg.raise_exit = self.cfg.add_node(None, "raise-exit")
        # innermost-first stacks
        self._loops: List[Tuple[int, List[Tuple[int, str]]]] = []
        self._handlers: List[List[int]] = []   # handler heads per try
        self._finals: List[List[ast.stmt]] = []  # enclosing finally bodies

    # ------------------------------------------------------------------ #
    def build(self, body: Sequence[ast.stmt]) -> CFG:
        frontier = self._block(body, [(self.cfg.entry, NORMAL)])
        self._connect(frontier, self.cfg.exit)
        return self.cfg

    def _connect(self, frontier: Sequence[Tuple[int, str]],
                 target: int) -> None:
        for u, kind in frontier:
            self.cfg.add_edge(u, target, kind)

    def _new(self, stmt: ast.stmt,
             frontier: Sequence[Tuple[int, str]]) -> int:
        n = self.cfg.add_node(stmt)
        self._connect(frontier, n)
        # statements lexically inside a try body may raise into that
        # try's handlers
        if self._handlers:
            for h in self._handlers[-1]:
                self.cfg.add_edge(n, h, EXC)
        return n

    def _abrupt(self, n: int, target: int) -> None:
        """Route an abrupt edge (return / raise-to-exit / break /
        continue) from node ``n`` through any enclosing finally bodies,
        then to ``target``."""
        frontier: List[Tuple[int, str]] = [(n, NORMAL)]
        for fin_body in reversed(self._finals):
            if not fin_body:
                continue
            frontier = self._block(fin_body, frontier)
        self._connect(frontier, target)

    # ------------------------------------------------------------------ #
    def _block(self, stmts: Sequence[ast.stmt],
               frontier: List[Tuple[int, str]]) -> List[Tuple[int, str]]:
        for stmt in stmts:
            if not frontier:
                # unreachable code after return/raise/break — still build
                # nodes (a checker may want their calls) but leave them
                # disconnected from the flow
                pass
            frontier = self._stmt(stmt, frontier)
        return frontier

    def _stmt(self, stmt: ast.stmt,
              frontier: List[Tuple[int, str]]) -> List[Tuple[int, str]]:
        cfg = self.cfg
        if isinstance(stmt, ast.If):
            n = self._new(stmt, frontier)
            then_f = self._block(stmt.body, [(n, TRUE)])
            else_f = self._block(stmt.orelse, [(n, FALSE)]) \
                if stmt.orelse else [(n, FALSE)]
            return then_f + else_f

        if isinstance(stmt, (ast.While, ast.For, ast.AsyncFor)):
            head = self._new(stmt, frontier)
            breaks: List[Tuple[int, str]] = []
            self._loops.append((head, breaks))
            body_f = self._block(stmt.body, [(head, TRUE)])
            self._loops.pop()
            for u, kind in body_f:
                cfg.add_edge(u, head, BACK)
            infinite = (isinstance(stmt, ast.While)
                        and isinstance(stmt.test, ast.Constant)
                        and bool(stmt.test.value))
            out: List[Tuple[int, str]] = [] if infinite else [(head, FALSE)]
            if stmt.orelse:
                out = self._block(stmt.orelse, out)
            return out + breaks

        if isinstance(stmt, ast.Break):
            n = self._new(stmt, frontier)
            if self._loops:
                self._loops[-1][1].append((n, NORMAL))
            return []

        if isinstance(stmt, ast.Continue):
            n = self._new(stmt, frontier)
            if self._loops:
                cfg.add_edge(n, self._loops[-1][0], BACK)
            return []

        if isinstance(stmt, ast.Return):
            n = self._new(stmt, frontier)
            self._abrupt(n, cfg.exit)
            return []

        if isinstance(stmt, ast.Raise):
            n = self._new(stmt, frontier)
            if self._handlers:
                # _new already wired the exc edges to the innermost
                # handlers; a raise has no normal successor
                pass
            else:
                self._abrupt(n, cfg.raise_exit)
            return []

        if isinstance(stmt, ast.Try):
            return self._try(stmt, frontier)

        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            n = self._new(stmt, frontier)
            return self._block(stmt.body, [(n, NORMAL)])

        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            # a nested def is a single binding statement here; its body
            # gets its own CFG when a checker asks for it
            n = self._new(stmt, frontier)
            return [(n, NORMAL)]

        # plain statement (Assign, Expr, AugAssign, Assert, ...)
        n = self._new(stmt, frontier)
        return [(n, NORMAL)]

    def _try(self, stmt: ast.Try,
             frontier: List[Tuple[int, str]]) -> List[Tuple[int, str]]:
        cfg = self.cfg
        head = self._new(stmt, frontier)   # the `try:` itself
        handler_heads: List[int] = []
        for h in stmt.handlers:
            hn = cfg.add_node(h)  # type: ignore[arg-type]
            handler_heads.append(hn)

        has_finally = bool(stmt.finalbody)
        if has_finally:
            self._finals.append(stmt.finalbody)
        self._handlers.append(handler_heads)
        body_f = self._block(stmt.body, [(head, NORMAL)])
        self._handlers.pop()

        out: List[Tuple[int, str]] = []
        if stmt.orelse:
            body_f = self._block(stmt.orelse, body_f)
        out.extend(body_f)

        for h, hn in zip(stmt.handlers, handler_heads):
            hf = self._block(h.body, [(hn, NORMAL)])
            out.extend(hf)
            # a handler that doesn't match re-raises: edge to the next
            # enclosing handlers, else the raise exit
            if self._handlers:
                for outer in self._handlers[-1]:
                    cfg.add_edge(hn, outer, EXC)
            else:
                cfg.add_edge(hn, cfg.raise_exit, EXC)

        if has_finally:
            self._finals.pop()
            out = self._block(stmt.finalbody, out)
        return out


def build_cfg(fn: ast.FunctionDef) -> CFG:
    """Build the CFG of one function/method body."""
    return _Builder(fn.name).build(fn.body)


def build_module_cfg(tree: ast.Module, name: str = "<module>") -> CFG:
    """CFG over a module's top-level statements (used by fixtures)."""
    return _Builder(name).build(tree.body)
