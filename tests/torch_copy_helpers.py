"""The text test of the port's copies of the reference's framework-free
modules (``test_torch_core.py``, ``test_torch_paper.py``)."""


def same_but_imports(port: str, ref: str) -> bool:
    """``port`` is ``ref`` with ``repro.`` rewritten to ``repro_torch.`` in
    its import statements and nowhere else."""
    p, r = port.splitlines(), ref.splitlines()
    if len(p) != len(r):
        return False
    in_import = False
    for a, b in zip(p, r):
        in_import = (a.startswith(("from ", "import "))
                     or (in_import and a.startswith(" ")))
        if a != b and not (in_import and
                           a.replace("repro_torch.", "repro.") == b):
            return False
    return True
