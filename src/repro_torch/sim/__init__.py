"""Plan-level trace simulator: time-stepped DRAM traffic for whole plans.

Where :mod:`repro_torch.core.simulate` validates one subgraph's row dataflow
with real data, this package executes an entire partition plan over time:
subgraphs in schedule order, tile/row granular, under the
consumption-centric memory-management scheme, with the next subgraph's
weights prefetched (double-buffered) beneath the current compute.  The
result is a :class:`TrafficTrace` — per-step DRAM bytes in/out, buffer
occupancy, and a derived :class:`BandwidthProfile` (peak, percentiles,
sustained) — plus a cross-validation layer asserting the simulated totals
equal the analytical kernel's EMA byte-for-byte.

Quickstart::

    from repro_torch.api import build_workload
    from repro_torch.core import AcceleratorConfig
    from repro_torch.sim import cross_validate, simulate_plan

    g = build_workload("synthetic:layered:12?seed=1")
    groups = [{v} for v in range(g.n)]           # or a search result's plan
    trace = simulate_plan(g, groups, AcceleratorConfig())
    print(trace.bandwidth_profile())
    cross_validate(g, groups, AcceleratorConfig()).raise_if_failed()

CLI: ``python -m repro_torch trace <workload-uri> [--out trace.json]``.
"""

from .bandwidth import (
    DEFAULT_PERCENTILES,
    BandwidthProfile,
    profile_from_steps,
)
from .lower import StepTraffic, SubgraphProgram, lower_plan, lower_subgraph
from .trace import (
    PROLOGUE,
    TRACE_FORMAT,
    TRACE_FORMAT_VERSION,
    SubgraphTrafficSummary,
    TraceStep,
    TrafficTrace,
    simulate_plan,
)
from .validate import (
    CrossValidationReport,
    SubgraphCheck,
    cross_validate,
    cross_validate_trace,
)

__all__ = [
    "BandwidthProfile",
    "CrossValidationReport",
    "DEFAULT_PERCENTILES",
    "PROLOGUE",
    "StepTraffic",
    "SubgraphCheck",
    "SubgraphProgram",
    "SubgraphTrafficSummary",
    "TRACE_FORMAT",
    "TRACE_FORMAT_VERSION",
    "TraceStep",
    "TrafficTrace",
    "cross_validate",
    "cross_validate_trace",
    "lower_plan",
    "lower_subgraph",
    "profile_from_steps",
    "simulate_plan",
]
