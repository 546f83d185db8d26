"""Elastic scaling (the JAX package's ``repro.runtime.elastic``): the
largest mesh the surviving devices support with the model axis kept, the
``DeviceMesh`` over the current process group for it, and the batch
rescaled to it.

On failure, the coordinator (a) drops dead hosts, (b) picks the largest
(data', model') grid the survivors support while keeping the model axis,
(c) restores the latest checkpoint into the new placements
(``checkpoint.manager.reshard_to``), and (d) replays the data stream from
the checkpoint step (data is step-indexed).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MeshPlan:
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def plan_mesh(n_devices: int, model_parallel: int,
              multi_pod: bool = False, pod_size: int = 256) -> MeshPlan:
    """Largest mesh using <= n_devices with a fixed model axis."""
    if n_devices < model_parallel:
        raise ValueError("fewer devices than the model-parallel degree")
    if multi_pod and n_devices >= 2 * pod_size:
        pods = n_devices // pod_size
        data = pod_size // model_parallel
        return MeshPlan((pods, data, model_parallel),
                        ("pod", "data", "model"))
    data = n_devices // model_parallel
    return MeshPlan((data, model_parallel), ("data", "model"))


def shrink_after_failure(current: MeshPlan, lost_devices: int) -> MeshPlan:
    """Elastic contraction: keep the model axis, shrink data (and pods)."""
    surviving = current.n_devices - lost_devices
    model = current.shape[-1]
    multi = len(current.shape) == 3
    if multi:
        pod_size = current.shape[1] * current.shape[2]
        if surviving >= 2 * pod_size:
            return plan_mesh(surviving, model, multi_pod=True,
                             pod_size=pod_size)
    data = max(1, surviving // model)
    return MeshPlan((data, model), ("data", "model"))


def build_mesh(plan: MeshPlan, device_type: Optional[str] = None):
    """``init_device_mesh`` of ``plan``'s shape and axis names over the
    current process group (ranks 0 .. n-1 of it), on ``device_type``
    (default: ``cuda`` for an NCCL group, else ``cpu``).  Raises when the
    group holds fewer ranks than the plan needs."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise ValueError("build_mesh needs a process group "
                         "(torch.distributed.init_process_group)")
    need, have = plan.n_devices, dist.get_world_size()
    if have < need:
        raise ValueError(f"need {need} devices, have {have}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, plan.shape,
                            mesh_dim_names=plan.axis_names)


def rescale_batch(global_batch: int, old_data: int, new_data: int) -> int:
    """Keep per-replica batch constant; shrink the global batch with the
    data axis."""
    per = global_batch // old_data
    return per * new_data
