"""Carry the JAX package's state into the port.

The planner has no weights: its state is the graph, the hardware point,
the spec and the result.  Each function here takes the reference's
serialized form (its JSON, or a plain dict of dataclass fields), never its
objects, so the port stays free of the reference's imports and the tests
compare like with like.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Mapping

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
