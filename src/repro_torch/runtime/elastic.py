"""Elastic scaling arithmetic (the JAX package's ``repro.runtime.elastic``):
the largest mesh the surviving devices support with the model axis kept,
and the batch rescaled to it.  Building a device mesh waits for the port's
meshes (ROADMAP A8).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple


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


def build_mesh(plan: MeshPlan, devices: Optional[Sequence] = None):
    """A device mesh for ``plan`` waits for the port's meshes."""
    raise NotImplementedError("build_mesh is not ported to repro_torch yet "
                              "(ROADMAP A8)")


def rescale_batch(global_batch: int, old_data: int, new_data: int) -> int:
    """Keep per-replica batch constant; shrink the global batch with the
    data axis."""
    per = global_batch // old_data
    return per * new_data
