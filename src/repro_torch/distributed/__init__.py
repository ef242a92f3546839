"""repro_torch.distributed — single-device fault tolerance (the preemption
guard, the straggler monitor, bounded retries, the elastic mesh shape)."""
from repro_torch.distributed.fault_tolerance import (  # noqa: F401
    PreemptionGuard,
    StragglerMonitor,
    elastic_mesh_shape,
    retry_on_transient,
)
