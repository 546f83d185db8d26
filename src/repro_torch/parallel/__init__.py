"""Logical-axis sharding over ``DeviceMesh`` / ``DTensor``, gradient
compression and pipeline stages (the JAX package's ``repro.parallel``)."""

from .sharding import (
    LogicalRules,
    axis_rules,
    current_mesh,
    current_rules,
    logical_sharding,
    mesh_context,
    placements_for,
    shard,
    spec_for,
)

__all__ = [k for k in dir() if not k.startswith("_")]
