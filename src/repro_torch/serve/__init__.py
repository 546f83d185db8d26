"""Serving layer of the port: the LM batch engine and the plan server.

``engine`` serves the decoder-only LMs and whisper's encoder-decoder on
torch.  The plan server
(``plans``/``zoo``) is the port's copy of ``repro.serve.plans`` and
``repro.serve.zoo``: stdlib HTTP over :mod:`repro_torch.api`, searching
on the ``torch`` backend on a device the caller names.
"""

from .engine import EncDecEngine, Request, ServeConfig, ServeEngine
from .plans import (
    PlanResponse,
    PlanServer,
    PlanService,
    fetch_stats,
    request_plan,
    resolve_plan,
    serve_in_thread,
)
from .zoo import (
    ZooBuildReport,
    build_zoo,
    default_zoo_workloads,
    verify_zoo,
    zoo_coverage,
    zoo_specs,
)

__all__ = [
    "EncDecEngine",
    "PlanResponse",
    "PlanServer",
    "PlanService",
    "Request",
    "ServeConfig",
    "ServeEngine",
    "ZooBuildReport",
    "build_zoo",
    "default_zoo_workloads",
    "fetch_stats",
    "request_plan",
    "resolve_plan",
    "serve_in_thread",
    "verify_zoo",
    "zoo_coverage",
    "zoo_specs",
]
