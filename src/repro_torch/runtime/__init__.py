from .elastic import (MeshPlan, build_mesh, plan_mesh, rescale_batch,
                      shrink_after_failure)
from .fault import (
    Decision,
    FaultConfig,
    HeartbeatMonitor,
    NodeState,
    RestartPolicy,
    mitigate_stragglers,
)

__all__ = ["Decision", "FaultConfig", "HeartbeatMonitor", "MeshPlan",
           "NodeState", "RestartPolicy", "build_mesh", "mitigate_stragglers",
           "plan_mesh", "rescale_batch", "shrink_after_failure"]
