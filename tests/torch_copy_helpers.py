"""The text test of the port's copies of the reference's framework-free
modules (``test_torch_core.py``, ``test_torch_paper.py``,
``test_torch_analysis.py``)."""
import re

_IMPORT = re.compile(r"^(from \S+ import .+|import \S.*)$")


def _units(text: str):
    """``text`` as a list of units: ("import", one import statement, its
    indent kept, its continuation lines joined and its whitespace
    collapsed) or ("line", any other line as it stands)."""
    lines = text.splitlines()
    out, i = [], 0
    while i < len(lines):
        line = lines[i]
        body = line.lstrip()
        if body.startswith(("from ", "import ")):
            j, depth = i, line.count("(") - line.count(")")
            while ((depth > 0 or lines[j].rstrip().endswith("\\"))
                   and j + 1 < len(lines)):
                j += 1
                depth += lines[j].count("(") - lines[j].count(")")
            joined = " ".join(" ".join(lines[i:j + 1]).replace("\\", " ")
                              .split())
            joined = joined.replace("( ", "(").replace(" )", ")")
            if _IMPORT.match(joined):
                out.append(("import", line[:len(line) - len(body)] + joined))
                i = j + 1
                continue
        out.append(("line", line))
        i += 1
    return out


def _ref_literal(lit: str) -> str:
    return lit.replace("repro_torch/", "repro/")


def same_but_imports(port: str, ref: str, literals=()) -> bool:
    """``port`` is ``ref`` with ``repro.`` rewritten to ``repro_torch.`` in
    its import statements (which may be wrapped differently) and, on other
    lines, each of the string ``literals`` (as they stand in ``port``, e.g.
    ``'"repro_torch/serving/"'``) standing where ``ref`` has it with
    ``repro/``; nothing else differs."""
    p, r = _units(port), _units(ref)
    if len(p) != len(r):
        return False
    for (kp, a), (kr, b) in zip(p, r):
        if kp != kr:
            return False
        if a == b:
            continue
        if kp == "import":
            if a.replace("repro_torch.", "repro.") != b:
                return False
            continue
        used = [lit for lit in literals if lit in a]
        if not used:
            return False
        for lit in used:
            a = a.replace(lit, _ref_literal(lit))
        if a != b:
            return False
    return True
