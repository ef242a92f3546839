"""repro_torch.distributed — fault tolerance (the preemption guard, the
straggler monitor, bounded retries, the elastic mesh shape) and the
multi-rank half: collectives over mesh axes (``collectives``), the
sharding rules and execution layout (``sharding``) and the cross-replica
desync digest (``desync``)."""
from repro_torch.distributed.fault_tolerance import (  # noqa: F401
    PreemptionGuard,
    StragglerMonitor,
    elastic_mesh_shape,
    retry_on_transient,
)
