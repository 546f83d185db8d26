"""Logical-axis sharding over ``torch.distributed`` device meshes (the JAX
package's ``repro.parallel.sharding``).

Model code names each tensor dim by a *logical* axis ("batch", "heads",
"embed", "expert", ...).  A rules table maps logical names to mesh axes,
and the mapping differs per parallelism strategy (TP, FSDP, decode-SP).
The reference hands the result to GSPMD as a ``PartitionSpec``; here it
becomes one ``DTensor`` placement per mesh dim:

    with mesh_context(mesh, rules):
        y = shard(x, "batch", "seq", None)        # x.redistribute(...)
        pl = logical_sharding(("vocab", "embed"))  # for distribute_tensor

:func:`spec_for` returns the reference's ``PartitionSpec`` entries as a
plain tuple (``None``, a mesh-axis name or a tuple of names per tensor
dim) and needs only the mesh's axis names, so it is held against the
reference without a process group.  :func:`placements_for` turns such a
tuple into placements.  Without a mesh, :func:`shard` is a no-op, as in
the reference.
"""

from __future__ import annotations

import sys
import threading
from contextlib import contextmanager
from typing import Dict, Optional, Sequence, Tuple, Union

Axes = Tuple[Optional[str], ...]
MeshAxis = Union[None, str, Tuple[str, ...]]
LogicalRules = Dict[str, MeshAxis]
Spec = Tuple[MeshAxis, ...]

_state = threading.local()

# default rules: single-pod (data, model) mesh, Megatron-style TP + FSDP
DEFAULT_RULES: LogicalRules = {
    "batch": ("pod", "data"),     # "pod" silently dropped if mesh lacks it
    "seq": None,
    "seq_kv": None,
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "ff": "model",
    "vocab": "model",
    "expert": "model",
    "expert_cap": None,
    "fsdp": "data",               # second param axis: ZeRO-style shard
    "seq_res": None,              # block-boundary residual stream: map to
                                  # "model" for Megatron sequence parallelism
    "mamba_inner": "model",
    "lstm_inner": "model",
    "kv_lora": None,
    "conv": None,
    "layers": None,               # stacked-scan leading axis
}


def is_dtensor(*tensors) -> bool:
    """Whether any of ``tensors`` is a ``DTensor``.  No ``DTensor`` exists
    before ``torch.distributed.tensor`` is imported, and importing it
    takes about a second, so a process that never makes one never
    imports it here."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and any(isinstance(t, mod.DTensor)
                                   for t in tensors)


def _get(name, default=None):
    return getattr(_state, name, default)


@contextmanager
def mesh_context(mesh, rules: Optional[LogicalRules] = None):
    """Make ``mesh`` (a ``DeviceMesh`` with ``mesh_dim_names``, or None)
    and ``rules`` (default :data:`DEFAULT_RULES`) current on this thread."""
    old_mesh, old_rules = _get("mesh"), _get("rules")
    _state.mesh = mesh
    _state.rules = dict(rules) if rules is not None else dict(DEFAULT_RULES)
    try:
        yield
    finally:
        _state.mesh = old_mesh
        _state.rules = old_rules


@contextmanager
def axis_rules(rules: LogicalRules):
    """Override only the rules (mesh unchanged)."""
    old = _get("rules")
    _state.rules = dict(rules)
    try:
        yield
    finally:
        _state.rules = old


def current_mesh():
    return _get("mesh")


def current_rules() -> LogicalRules:
    return _get("rules") or dict(DEFAULT_RULES)


def axis_names(mesh) -> Tuple[str, ...]:
    """The mesh-axis names of a ``DeviceMesh`` (``mesh_dim_names``), of
    anything with ``axis_names`` (a JAX mesh), or of a tuple of names."""
    if isinstance(mesh, (tuple, list)):
        return tuple(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        names = getattr(mesh, "axis_names", None)
    if names is None:
        raise ValueError(f"{mesh!r} has no mesh-axis names (build the "
                         f"DeviceMesh with mesh_dim_names)")
    return tuple(names)


def _mesh_axes(entry: MeshAxis, mesh) -> MeshAxis:
    """Drop mesh axes that don't exist (e.g. 'pod' on a single-pod mesh)."""
    names = axis_names(mesh)
    if entry is None:
        return None
    if isinstance(entry, str):
        return entry if entry in names else None
    kept = tuple(a for a in entry if a in names)
    return kept if len(kept) > 1 else (kept[0] if kept else None)


def spec_for(axes: Sequence[Optional[str]],
             rules: Optional[LogicalRules] = None, mesh=None) -> Spec:
    """The reference's ``PartitionSpec`` for a tuple of logical axis
    names, as a tuple with one entry per tensor dim (``()`` without a
    mesh, as ``PS()``)."""
    mesh = mesh if mesh is not None else current_mesh()
    rules = rules or current_rules()
    if mesh is None:
        return ()
    used = set()
    parts = []
    for ax in axes:
        entry = _mesh_axes(rules.get(ax), mesh) if ax is not None else None
        # a mesh axis may appear at most once in a PartitionSpec
        if entry is not None:
            flat = (entry,) if isinstance(entry, str) else tuple(entry)
            flat = tuple(a for a in flat if a not in used)
            used.update(flat)
            entry = flat if len(flat) > 1 else (flat[0] if flat else None)
        parts.append(entry)
    return tuple(parts)


def placements_for(spec: Spec, mesh) -> tuple:
    """One ``DTensor`` placement per mesh dim for a :func:`spec_for`
    tuple: ``Shard(d)`` on each mesh dim that tensor dim ``d`` is sharded
    over, ``Replicate()`` elsewhere.  A tensor dim sharded over several
    mesh axes is split major to minor in the mesh's axis order, as the
    reference splits it; a spec that lists them in another order raises."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        flat = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in flat]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} orders its mesh axes "
                             f"otherwise than the mesh {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def logical_sharding(axes: Sequence[Optional[str]], mesh=None,
                     rules: Optional[LogicalRules] = None):
    """The placements ``distribute_tensor(t, mesh, ...)`` takes for a
    tensor with logical ``axes`` (None without a mesh)."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        return None
    return placements_for(spec_for(axes, rules, mesh), mesh)


def even_placements(placements: tuple, shape, mesh) -> tuple:
    """``placements`` with each ``Shard(d)`` that does not split tensor dim
    ``d`` evenly replaced by ``Replicate()``: mesh dims are taken major to
    minor, and one whose size, times those of the mesh dims before it that
    shard the same tensor dim, does not divide it replicates instead."""
    from torch.distributed.tensor import Replicate, Shard

    out, ways = [], {}
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            n = ways.get(p.dim, 1) * mesh.size(i)
            if shape[p.dim] % n:
                p = Replicate()
            else:
                ways[p.dim] = n
        out.append(p)
    return tuple(out)


def shard(x, *axes: Optional[str]):
    """Redistribute a ``DTensor`` to the placements of ``axes``; a no-op
    without a mesh (and on a plain tensor, which no mesh holds).

    A tensor dim that its mesh axis does not divide is replicated over
    that axis instead (:func:`even_placements`).  GSPMD pads such a dim
    to a multiple of the axis and shards it; the values are the same
    either way, only the communication differs.  (``DTensor`` can hold
    an uneven shard, but redistributing one under ``FakeTensorMode``
    raises ``DataDependentOutputException``, so a traced step on a fake
    world could not take it.)"""
    mesh = current_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    placements = even_placements(
        placements_for(spec_for(axes, mesh=mesh), mesh), x.shape,
        x.device_mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)
