"""Import shim with the reference's names (``repro.serve.faults``): the
fault injector and the clocks live in :mod:`repro_torch.faults`, shared
by the stencil service and the resumable campaign runner — the same
seeded determinism contract.  Import from ``repro_torch.faults`` going
forward; this module keeps the serving names resolving.
"""
from repro_torch.faults import (CAMPAIGN_KINDS, HEALTHY,  # noqa: F401
                                TRAFFIC_KINDS, FaultConfig, FaultInjector,
                                MonotonicClock, SimClock, TransientFault)

__all__ = [
    "CAMPAIGN_KINDS",
    "FaultConfig",
    "FaultInjector",
    "HEALTHY",
    "MonotonicClock",
    "SimClock",
    "TRAFFIC_KINDS",
    "TransientFault",
]
