"""Production meshes and per-arch / per-cell sharding rules (the JAX
package's ``repro.launch.mesh``).

``make_production_mesh`` is a FUNCTION (importing this module builds no
process group or mesh).  Single pod: (16, 16) = (data, model), 256
devices.  Multi-pod: (2, 16, 16) = (pod, data, model), 512 devices; the
pod axis composes with data parallelism by default and can be re-bound to
pipeline stages (:mod:`repro_torch.parallel.pipeline`).
"""

from __future__ import annotations

from typing import Optional

from repro_torch.models.config import ModelConfig
from repro_torch.parallel.sharding import DEFAULT_RULES, LogicalRules


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """A ``DeviceMesh`` of shape (16, 16) or (2, 16, 16) over the current
    process group, which must hold that many ranks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 1
    for s in shape:
        need *= s
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise ValueError(f"the production mesh {shape} needs a world of "
                         f"{need} ranks, this process group has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


MODEL_AXIS = 16  # TP/EP degree on the production meshes


def rules_for(cfg: ModelConfig, kind: str,
              overrides: Optional[LogicalRules] = None) -> LogicalRules:
    """Sharding rules per (arch, cell-kind).

    Baseline strategy:
      * train/prefill: batch -> (pod, data); TP on heads/ff/vocab/experts;
        ZeRO on the second weight axis of experts (fsdp).
      * decode: additionally shard the KV cache sequence on `model`.
    Archs whose head counts don't divide the 16-way model axis shard inner
    projection dims instead (xlstm).
    """
    rules = dict(DEFAULT_RULES)
    if kind == "decode":
        rules["seq_kv"] = "model"
    if kind in ("prefill", "decode"):
        rules["fsdp"] = None        # no ZeRO at inference; params TP-only
    # head-count divisibility fixes
    if cfg.n_heads % MODEL_AXIS != 0:
        rules["heads"] = None
    if cfg.n_kv_heads % MODEL_AXIS != 0:
        rules["kv_heads"] = None
    if cfg.n_experts and cfg.n_experts % MODEL_AXIS != 0:
        rules["expert"] = None
    if cfg.d_ff and cfg.d_ff % MODEL_AXIS != 0:
        rules["ff"] = None
    if cfg.vocab % MODEL_AXIS != 0:
        rules["vocab"] = None
    if (2 * cfg.mamba_expand * cfg.d_model) % MODEL_AXIS != 0:
        rules["mamba_inner"] = None
    if (4 * cfg.d_model) % MODEL_AXIS != 0:
        rules["lstm_inner"] = None
    # long-context decode with batch 1: spread the sequence over everything
    if kind == "decode_long":
        rules["seq_kv"] = ("data", "model")
        rules["batch"] = None
        rules["fsdp"] = None
    if overrides:
        rules.update(overrides)
    return rules
