"""Carry the JAX package's state into the port.

The planner has no weights: its state is the graph, the hardware point,
the spec and the result.  The LM's state is its parameter tree.  Each
function here takes the reference's serialized form (its JSON, a plain dict
of dataclass fields, or NumPy arrays), never its objects, so the port stays
free of the reference's imports and the tests compare like with like.
"""

from __future__ import annotations

import json
import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.api.result import ExploreResult
from repro_torch.api.spec import ExploreSpec
from repro_torch.core.cost import AcceleratorConfig
from repro_torch.core.graph import Graph, graph_from_json


def graph_from_reference(json_str: str) -> Graph:
    """A graph from the reference's ``graph_to_json`` output."""
    return graph_from_json(json_str)


def acc_from_reference(fields: Mapping[str, Any]) -> AcceleratorConfig:
    """A hardware point from ``dataclasses.asdict`` of the reference's
    ``AcceleratorConfig`` (an unknown field raises ``TypeError``)."""
    return AcceleratorConfig(**dict(fields))


def spec_from_reference(json_str: str) -> ExploreSpec:
    """A spec from the reference's ``ExploreSpec.to_json`` output."""
    return ExploreSpec.from_json(json_str)


def result_to_reference_dict(res: ExploreResult) -> Dict[str, Any]:
    """The result as the parsed JSON the reference's
    ``ExploreResult.to_json`` writes, for dict comparison with it."""
    return json.loads(res.to_json())


_KEYSTR_PART = re.compile(r"\['([^']*)'\]")


def _unflatten_keystr(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """``{"['scan']['p0']['mixer']['wq']": a, ...}`` -> nested dicts."""
    tree: Dict[str, Any] = {}
    for key, arr in flat.items():
        parts = _KEYSTR_PART.findall(key)
        if not parts or "".join(f"['{p}']" for p in parts) != key:
            raise ValueError(f"not a jax.tree_util.keystr path of dict "
                             f"keys: {key!r}")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = arr
    return tree


def lm_params_from_reference(arrays: Mapping[str, Any], device="cpu",
                             dtype=None) -> Dict[str, Any]:
    """The port's LM value tree from the reference's
    ``param_values(lm_init(...))`` as NumPy arrays: either the nested dict
    itself, or flat ``{jax.tree_util.keystr(path): array}`` as
    ``save_checkpoint`` names its leaves.  Floating arrays become tensors of
    ``dtype`` (default: their own) on ``device``."""
    flat = bool(arrays) and all(isinstance(k, str) and k.startswith("['")
                                for k in arrays)
    tree = _unflatten_keystr(arrays) if flat else arrays

    def convert(node):
        if isinstance(node, Mapping):
            return {k: convert(v) for k, v in node.items()}
        t = torch.from_numpy(np.array(node, copy=True))
        if dtype is not None and torch.is_floating_point(t):
            t = t.to(dtype)
        return t.to(device)

    return convert(tree)


def adamw_state_from_reference(step, mu: Mapping[str, Any],
                               nu: Mapping[str, Any], device="cpu"):
    """The port's ``AdamWState`` from the reference's ``AdamWState``
    fields as NumPy arrays: ``step`` (int32 scalar) and the moment trees
    ``mu`` and ``nu`` (nested, or flat ``keystr`` paths as
    :func:`lm_params_from_reference` takes them)."""
    from repro_torch.train import AdamWState

    return AdamWState(
        step=torch.tensor(np.asarray(step), dtype=torch.int32, device=device),
        mu=lm_params_from_reference(mu, device),
        nu=lm_params_from_reference(nu, device))
