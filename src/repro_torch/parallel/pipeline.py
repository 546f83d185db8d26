"""GPipe-style pipeline parallelism over a mesh axis (the JAX package's
``repro.parallel.pipeline``).

The `pod` (or any) axis can be re-bound to pipeline stages: stage ``s``
holds slice ``s`` of the stacked stage parameters, activations flow stage
to stage by point-to-point sends in the stage group
(``torch.distributed.batch_isend_irecv``, the reference's ``ppermute``),
and microbatches fill the pipeline (bubble fraction (P-1)/(M+P-1)).
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.models.layers import tree_map

from .sharding import is_dtensor


def _stage_slice(leaf, stage: int):
    """This stage's slice of a leaf with a leading stage dim: the local
    shard of a ``DTensor`` sharded on it, or row ``stage`` of a tensor
    every stage holds whole."""
    if is_dtensor(leaf):
        local = leaf.to_local()
        if local.shape[0] != 1:
            raise ValueError(f"a stage holds {local.shape[0]} rows of a "
                             f"stage-sharded leaf, expected 1")
        return local[0]
    return leaf[stage]


def _rotate(y: torch.Tensor, group, stage: int, n: int) -> torch.Tensor:
    """``y`` to stage ``stage + 1``, the previous stage's ``y`` back (the
    reference's ``ppermute`` with pairs ``(i, (i + 1) % P)``)."""
    if n == 1:
        return y
    y = y.contiguous()
    out = torch.empty_like(y)
    ops = [dist.P2POp(dist.isend, y,
                      dist.get_global_rank(group, (stage + 1) % n), group),
           dist.P2POp(dist.irecv, out,
                      dist.get_global_rank(group, (stage - 1) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def pipeline_apply(
    fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,            # nested dicts, leaves [P_stages, ...]
    x: torch.Tensor,              # [M_microbatches, mb, ...] (every stage)
    mesh,
    axis: str = "pod",
) -> torch.Tensor:
    """Run M microbatches through P pipeline stages; returns the outputs
    in microbatch order, on every stage.  The classic rotating-buffer
    GPipe loop: at tick t, stage s processes microbatch (t - s) if
    0 <= t - s < M."""
    group = mesh.get_group(axis)
    P = mesh.size(mesh.mesh_dim_names.index(axis))
    stage = mesh.get_local_rank(axis)
    M = x.shape[0]
    params_local = tree_map(lambda p: _stage_slice(p, stage), stage_params)
    buf = torch.zeros_like(x)                   # outputs (stage P-1 only)
    carry = torch.zeros_like(x[0])              # inter-stage activation
    for t in range(M + P - 1):
        mb_idx = t - stage
        active = 0 <= mb_idx < M
        # stage 0 ingests fresh microbatches; the others take the carry
        x_in = x[min(max(mb_idx, 0), M - 1)] if (
            stage == 0 and mb_idx >= 0) else carry
        y = fn(params_local, x_in) if active else x_in
        if active and stage == P - 1:           # record a finished one
            buf[mb_idx] = y
        carry = _rotate(y, group, stage, P)
    # only stage P-1 holds real outputs; sum the masked buffers to all
    if stage != P - 1:
        buf.zero_()
    dist.all_reduce(buf, group=group)
    return buf


def pipeline_bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_microbatches + n_stages - 1)
