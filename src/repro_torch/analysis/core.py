"""repro-lint framework: project model, pragmas, findings, baseline.

The unit of analysis is a *project* — every ``*.py`` under a source root
(normally ``src/``), indexed per module with its AST, its functions
(qualnames like ``ClassName.method``), and its suppression pragmas.

Suppression pragma (DESIGN.md SS18)::

    # repro: allow(<rule>): <justification>

placed on the offending line or the line directly above it. The
justification text is REQUIRED — a pragma without one is itself a
finding (rule ``pragma``), so every suppression in the tree carries a
written reason. Unknown rule names are also flagged.

Baseline: a committed JSON file mapping finding fingerprints to
justifications, for grandfathered findings that predate a checker.
Fingerprints hash (rule, path, qualname, message) — no line numbers, so
unrelated edits don't churn the baseline.
"""
from __future__ import annotations

import ast
import hashlib
import io
import json
import re
import tokenize
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

# every rule id a checker may emit or a pragma may name
KNOWN_RULES = (
    "resource-pairing",
    "host-sync",
    "wall-clock",
    "traced-purity",
    "accounting",
    "channel-vocab",
    "config-drift",
    "pragma",
)

_PRAGMA_RE = re.compile(
    r"#\s*repro:\s*allow\(([a-z-]+)\)\s*(?::\s*(.*?))?\s*$")


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str          # project-relative, e.g. "repro/serving/engine.py"
    line: int
    qualname: str      # enclosing function, or "<module>"
    message: str

    @property
    def fingerprint(self) -> str:
        h = hashlib.sha256(
            f"{self.rule}|{self.path}|{self.qualname}|{self.message}"
            .encode()).hexdigest()
        return h[:16]

    def render(self) -> str:
        return (f"{self.path}:{self.line}: [{self.rule}] "
                f"{self.qualname}: {self.message}")

    def to_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "qualname": self.qualname, "message": self.message,
                "fingerprint": self.fingerprint}


@dataclass
class Pragma:
    line: int
    rule: str
    justification: str


@dataclass
class FunctionInfo:
    qualname: str
    node: ast.FunctionDef
    cls: Optional[ast.ClassDef] = None


@dataclass
class ModuleInfo:
    path: Path
    rel: str
    source: str
    tree: ast.Module
    pragmas: List[Pragma] = field(default_factory=list)
    functions: List[FunctionInfo] = field(default_factory=list)

    def allowed(self, rule: str, line: int) -> bool:
        """True when a pragma on ``line`` or the line above names
        ``rule`` (malformed pragmas never suppress)."""
        return any(p.rule == rule and p.justification
                   and p.line in (line, line - 1)
                   for p in self.pragmas)


@dataclass
class Project:
    root: Path                       # the source root (…/src)
    modules: List[ModuleInfo]
    by_rel: Dict[str, ModuleInfo] = field(default_factory=dict)

    def __post_init__(self):
        self.by_rel = {m.rel: m for m in self.modules}

    def module(self, rel: str) -> Optional[ModuleInfo]:
        return self.by_rel.get(rel)

    def in_dir(self, prefix: str) -> List[ModuleInfo]:
        return [m for m in self.modules if m.rel.startswith(prefix)]

    # ---------------- import resolution ------------------------------- #
    def resolve_import(self, mod: ModuleInfo, name: str, _depth: int = 0
                       ) -> Optional[Tuple[ModuleInfo, ast.AST]]:
        """Resolve ``name`` (used in ``mod``) to its defining module and
        def node, following ``from repro.x import name`` one
        ``__init__`` re-export hop deep."""
        if _depth > 3:
            return None
        # defined locally?
        for node in mod.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)) and node.name == name:
                return mod, node
        for node in mod.tree.body:
            if isinstance(node, ast.ImportFrom) and node.module:
                for alias in node.names:
                    if (alias.asname or alias.name) != name:
                        continue
                    target = self._module_for(node.module, mod, node.level)
                    if target is None:
                        return None
                    return self.resolve_import(target, alias.name,
                                               _depth + 1)
        return None

    def _module_for(self, dotted: str, frm: ModuleInfo,
                    level: int) -> Optional[ModuleInfo]:
        if level:  # relative import: resolve against the importer's pkg
            base = Path(frm.rel).parent
            for _ in range(level - 1):
                base = base.parent
            parts = list(base.parts) + (dotted.split(".") if dotted else [])
        else:
            parts = dotted.split(".")
        rel = "/".join(parts)
        return self.by_rel.get(rel + ".py") or self.by_rel.get(
            rel + "/__init__.py")


def _parse_pragmas(source: str) -> List[Pragma]:
    out: List[Pragma] = []
    try:
        toks = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in toks:
            if tok.type != tokenize.COMMENT:
                continue
            m = _PRAGMA_RE.search(tok.string)
            if m:
                out.append(Pragma(tok.start[0], m.group(1),
                                  (m.group(2) or "").strip()))
    except tokenize.TokenError:
        pass
    return out


def _index_functions(tree: ast.Module) -> List[FunctionInfo]:
    out: List[FunctionInfo] = []

    def visit(node: ast.AST, prefix: str, cls: Optional[ast.ClassDef]):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{prefix}{child.name}"
                out.append(FunctionInfo(q, child, cls))
                visit(child, q + ".", cls)
            elif isinstance(child, ast.ClassDef):
                visit(child, f"{prefix}{child.name}.", child)

    visit(tree, "", None)
    return out


def load_module(path: Path, rel: str) -> ModuleInfo:
    source = path.read_text()
    tree = ast.parse(source, filename=str(path))
    return ModuleInfo(path=path, rel=rel, source=source, tree=tree,
                      pragmas=_parse_pragmas(source),
                      functions=_index_functions(tree))


def load_project(src_root: Path,
                 rel_prefix: str = "repro_torch/") -> Project:
    """Load every ``*.py`` under ``src_root`` whose project-relative path
    starts with ``rel_prefix`` (default: the repro package)."""
    src_root = Path(src_root)
    modules = []
    for path in sorted(src_root.rglob("*.py")):
        rel = path.relative_to(src_root).as_posix()
        if not rel.startswith(rel_prefix):
            continue
        modules.append(load_module(path, rel))
    return Project(root=src_root, modules=modules)


# ---------------------------------------------------------------------- #
# AST call helpers shared by the checkers
# ---------------------------------------------------------------------- #

def attr_chain(node: ast.AST) -> List[str]:
    """``self.kv.reserve_ahead`` -> ["self", "kv", "reserve_ahead"];
    returns [] for expressions that aren't plain name/attribute chains."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return list(reversed(parts))
    return []


def call_name(call: ast.Call) -> str:
    """Terminal name of a call: ``self.kv.reserve_ahead(...)`` ->
    ``reserve_ahead``; ``foo(...)`` -> ``foo``; else ``""``."""
    chain = attr_chain(call.func)
    return chain[-1] if chain else ""


def call_recv(call: ast.Call) -> str:
    """Terminal receiver segment: ``self.kv.reserve_ahead`` -> ``kv``;
    bare ``foo(...)`` -> ``""``."""
    chain = attr_chain(call.func)
    return chain[-2] if len(chain) >= 2 else ""


def calls_in(node: ast.AST) -> List[ast.Call]:
    return [n for n in ast.walk(node) if isinstance(n, ast.Call)]


def stmt_calls(stmt: ast.AST) -> List[ast.Call]:
    """Calls belonging to ONE CFG node. For compound statements only the
    header expression counts (``while <test>:``, ``for t in <iter>:``,
    ``with <items>:``, ``except <type>:``) — body statements are their
    own CFG nodes and must not be double-attributed to the head. Calls
    nested in an inner function/lambda are excluded everywhere."""
    if isinstance(stmt, (ast.If, ast.While)):
        roots: List[ast.AST] = [stmt.test]
    elif isinstance(stmt, (ast.For, ast.AsyncFor)):
        roots = [stmt.target, stmt.iter]
    elif isinstance(stmt, (ast.With, ast.AsyncWith)):
        roots = [i.context_expr for i in stmt.items]
    elif isinstance(stmt, ast.Try):
        roots = []
    elif isinstance(stmt, ast.ExceptHandler):
        roots = [stmt.type] if stmt.type is not None else []
    elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
        roots = []
    else:
        roots = [stmt]
    out: List[ast.Call] = []
    stack: List[ast.AST] = list(roots)
    while stack:
        n = stack.pop()
        if isinstance(n, ast.Call):
            out.append(n)
        for child in ast.iter_child_nodes(n):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            stack.append(child)
    return out


# ---------------------------------------------------------------------- #
# Checker registry + baseline
# ---------------------------------------------------------------------- #

Checker = Callable[[Project], List[Finding]]


def pragma_findings(project: Project) -> List[Finding]:
    """Meta-checks on the pragmas themselves: a justification is
    required, and the rule name must exist."""
    out: List[Finding] = []
    for mod in project.modules:
        for p in mod.pragmas:
            if p.rule not in KNOWN_RULES:
                out.append(Finding(
                    "pragma", mod.rel, p.line, "<module>",
                    f"pragma names unknown rule '{p.rule}'"))
            elif not p.justification:
                out.append(Finding(
                    "pragma", mod.rel, p.line, "<module>",
                    f"allow({p.rule}) pragma has no justification text"))
    return out


def run_checkers(project: Project,
                 checkers: Optional[Sequence[Checker]] = None
                 ) -> List[Finding]:
    """Run checkers (default: all five + pragma meta-checks), dropping
    findings suppressed by a well-formed pragma."""
    if checkers is None:
        from repro_torch.analysis.checkers import ALL_CHECKERS
        checkers = ALL_CHECKERS
    findings: List[Finding] = list(pragma_findings(project))
    for check in checkers:
        for f in check(project):
            mod = project.module(f.path)
            if mod is not None and mod.allowed(f.rule, f.line):
                continue
            findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def load_baseline(path: Path) -> Dict[str, dict]:
    """Load the committed baseline; returns {fingerprint: entry}.
    Raises ValueError when an entry lacks a justification."""
    if not path.exists():
        return {}
    doc = json.loads(path.read_text())
    out: Dict[str, dict] = {}
    for entry in doc.get("findings", []):
        fp = entry.get("fingerprint", "")
        if not entry.get("justification", "").strip():
            raise ValueError(
                f"baseline entry {fp or entry} has no justification")
        out[fp] = entry
    return out


def apply_baseline(findings: Sequence[Finding], baseline: Dict[str, dict]
                   ) -> Tuple[List[Finding], List[dict]]:
    """Split findings into (new, stale-baseline-entries). A baseline
    entry is stale when no current finding matches its fingerprint."""
    live = {f.fingerprint for f in findings}
    new = [f for f in findings if f.fingerprint not in baseline]
    stale = [e for fp, e in baseline.items() if fp not in live]
    return new, stale


def write_baseline(path: Path, findings: Sequence[Finding],
                   justification: str = "grandfathered at baseline"
                   ) -> None:
    doc = {"findings": [dict(f.to_dict(), justification=justification)
                        for f in findings]}
    path.write_text(json.dumps(doc, indent=2, sort_keys=True) + "\n")
