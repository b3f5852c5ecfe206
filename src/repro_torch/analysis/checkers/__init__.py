"""The five repo-specific checkers (DESIGN.md SS18), over the port.

Each module exposes ``check(project) -> list[Finding]``; ``ALL_CHECKERS``
is the ordered registry ``python -m repro_torch.analysis`` and the tests
run. ``resource``, ``accounting`` and ``config_drift`` are the
reference's checkers over ``repro_torch/``; ``host_sync`` and ``purity``
know the torch idioms (device->host pulls, CUDA-graph capture).
"""
from repro_torch.analysis.checkers.accounting import check as check_accounting
from repro_torch.analysis.checkers.config_drift import \
    check as check_config_drift
from repro_torch.analysis.checkers.host_sync import check as check_host_sync
from repro_torch.analysis.checkers.purity import check as check_purity
from repro_torch.analysis.checkers.resource import check as check_resource

ALL_CHECKERS = (
    check_resource,
    check_host_sync,
    check_purity,
    check_accounting,
    check_config_drift,
)

__all__ = ["ALL_CHECKERS", "check_resource", "check_host_sync",
           "check_purity", "check_accounting", "check_config_drift"]
