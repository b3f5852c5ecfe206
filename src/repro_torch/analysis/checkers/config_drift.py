"""Checker 5 — config/CLI drift (rule ``config-drift``).

``launch/serve.py`` is the paper-reproduction front door: a flag that
parses but is silently ignored produces a benchmark run that LOOKS
configured (the flag is in the command line the paper artifact records)
while measuring something else. Three static closures prevent that:

* every ``add_argument("--flag")`` must have its dest read somewhere in
  ``serve.py`` (``args.flag`` / an explicit ``dest=``);
* every keyword passed at a ``ServeEngine(...)`` construction site in
  ``serve.py`` must be a real ``ServeEngine.__init__`` parameter;
* every ``ServeEngine.__init__`` parameter must be consumed by the
  constructor body (an accepted-but-unused parameter is the same bug
  one layer down).
"""
from __future__ import annotations

import ast
from typing import List, Optional, Set

from repro_torch.analysis.core import (Finding, ModuleInfo, Project,
                                       attr_chain, call_name)

RULE = "config-drift"
SERVE_REL = "repro_torch/launch/serve.py"
ENGINE_REL = "repro_torch/serving/engine.py"


def _flags(serve: ModuleInfo) -> List[tuple]:
    out = []
    for node in ast.walk(serve.tree):
        if not (isinstance(node, ast.Call)
                and call_name(node) == "add_argument"):
            continue
        flag = None
        for a in node.args:
            if isinstance(a, ast.Constant) and isinstance(a.value, str) \
                    and a.value.startswith("--"):
                flag = a.value
                break
        if flag is None:
            continue
        dest = None
        for kw in node.keywords:
            if kw.arg == "dest" and isinstance(kw.value, ast.Constant):
                dest = kw.value.value
        if dest is None:
            dest = flag.lstrip("-").replace("-", "_")
        out.append((flag, dest, node.lineno))
    return out


def _args_reads(serve: ModuleInfo) -> Set[str]:
    reads: Set[str] = set()
    for node in ast.walk(serve.tree):
        if isinstance(node, ast.Attribute):
            chain = attr_chain(node)
            if len(chain) == 2 and chain[0] == "args":
                reads.add(chain[1])
    return reads


def _engine_init(engine: ModuleInfo) -> Optional[ast.FunctionDef]:
    for node in engine.tree.body:
        if isinstance(node, ast.ClassDef) and node.name == "ServeEngine":
            for item in node.body:
                if isinstance(item, ast.FunctionDef) \
                        and item.name == "__init__":
                    return item
    return None


def _init_params(init: ast.FunctionDef) -> Set[str]:
    names = {a.arg for a in init.args.args} \
        | {a.arg for a in init.args.kwonlyargs}
    names.discard("self")
    return names


def check(project: Project) -> List[Finding]:
    out: List[Finding] = []
    serve = project.module(SERVE_REL)
    engine = project.module(ENGINE_REL)

    init = _engine_init(engine) if engine is not None else None
    init_params = _init_params(init) if init is not None else set()

    if serve is not None:
        reads = _args_reads(serve)
        for flag, dest, line in _flags(serve):
            if dest not in reads:
                out.append(Finding(
                    RULE, SERVE_REL, line, "<module>",
                    f"flag '{flag}' is parsed but args.{dest} is never "
                    f"read — the CLI silently ignores it"))
        # ServeEngine(...) call sites must use real constructor params
        if init_params:
            for node in ast.walk(serve.tree):
                if isinstance(node, ast.Call) \
                        and call_name(node) == "ServeEngine":
                    for kw in node.keywords:
                        if kw.arg is not None \
                                and kw.arg not in init_params:
                            out.append(Finding(
                                RULE, SERVE_REL, node.lineno, "<module>",
                                f"ServeEngine(...) passes unknown "
                                f"keyword '{kw.arg}'"))

    if init is not None:
        # every accepted parameter must be consumed in the body
        body_names: Set[str] = set()
        for stmt in init.body:
            for n in ast.walk(stmt):
                if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load):
                    body_names.add(n.id)
        for p in sorted(_init_params(init)):
            if p not in body_names:
                out.append(Finding(
                    RULE, ENGINE_REL, init.lineno, "ServeEngine.__init__",
                    f"constructor parameter '{p}' is accepted but never "
                    f"consumed"))
    return out
