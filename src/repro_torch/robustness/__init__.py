"""repro_torch.robustness — deterministic fault injection."""
from repro_torch.robustness.faults import (  # noqa: F401
    NO_FAULTS,
    FaultPlan,
    FaultSpec,
    InjectedFault,
)
