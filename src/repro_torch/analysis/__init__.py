"""repro-lint over the port: AST/CFG static analysis for the serving
stack's invariants (the reference is ``repro.analysis``, DESIGN.md SS18).

The package is pure ``ast`` code (it imports no ``torch`` of its own) and
keeps its own copy of the reference's framework:

* :mod:`repro_torch.analysis.cfg` — intra-procedural control-flow graphs
  over Python AST, with exception edges, loop back edges, and path walks.
* :mod:`repro_torch.analysis.core` — project loading, call-name
  resolution, ``# repro: allow(<rule>): why`` suppression pragmas,
  finding fingerprints and the committed-baseline workflow.
* :mod:`repro_torch.analysis.checkers` — the five checkers: resource
  pairing, host-sync/wall-clock discipline (torch's pulls), capture
  purity (the bodies CUDA-graph capture will stage), accounting
  completeness, and config/CLI drift.

Entry point: ``python -m repro_torch.analysis`` (human + ``--json``
output, nonzero exit on findings not covered by the baseline
``analysis_baseline_torch.json``).
"""
from repro_torch.analysis.core import (Finding, Project, load_project,
                                       run_checkers)

__all__ = ["Finding", "Project", "load_project", "run_checkers"]
