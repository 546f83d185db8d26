"""Unified exploration API: ``ExploreSpec`` -> strategy registry -> ``ExploreResult``.

The port's copy of ``repro.api``: one serializable surface for every search
method (GA, greedy, DP, SA, two-step, exhaustive enumeration) and every cost
backend, behind the ``python -m repro_torch`` CLI.  Quickstart::

    from repro_torch.api import ExploreSpec, run
    spec = ExploreSpec(workload="resnet50", strategy="ga", sample_budget=4000)
    print(run(spec, eval_backend="torch", device="cuda").summary())

Specs and results round-trip losslessly through JSON
(``spec == ExploreSpec.from_json(spec.to_json())``), so any run can be
archived, shared, and reproduced bit-for-bit from its artifact.  Use
:func:`compare` to run several strategies on one spec with a shared cost
evaluator (``jobs=N`` fans them out over worker processes), a
:class:`ResultStore` to make re-runs of any already-searched spec instant,
and :func:`register_strategy` to plug in new methods.

Workloads are URIs resolved by :mod:`repro_torch.api.workloads`
(``netlib:resnet50``, ``synthetic:layered:24?seed=7``, ``file:graph.json``;
bare names alias to ``netlib:``) — see :func:`register_workload_scheme` to
add a scheme, and ``python -m repro_torch workloads ls`` to enumerate what
resolves.
"""

from .registry import (
    Strategy,
    StrategyEntry,
    get_strategy,
    list_strategies,
    register_strategy,
)
from .spec import (
    DPOptions,
    EnumOptions,
    ExploreSpec,
    GAOptions,
    GreedyOptions,
    SAOptions,
    TwoStepOptions,
)
from .result import ExploreResult
from .store import (
    ResultStore,
    StoreEntry,
    StoreLockTimeout,
    StoreReadOnly,
    graph_fingerprint,
    spec_key,
)
from .strategies import active_store, compare, run
from .workloads import (
    WorkloadScheme,
    build_workload,
    list_workloads,
    parse_workload,
    register_workload_scheme,
    workload_schemes,
)

__all__ = [
    "DPOptions",
    "EnumOptions",
    "ExploreResult",
    "ExploreSpec",
    "GAOptions",
    "GreedyOptions",
    "ResultStore",
    "SAOptions",
    "StoreEntry",
    "StoreLockTimeout",
    "StoreReadOnly",
    "Strategy",
    "StrategyEntry",
    "TwoStepOptions",
    "WorkloadScheme",
    "active_store",
    "build_workload",
    "compare",
    "get_strategy",
    "graph_fingerprint",
    "list_strategies",
    "list_workloads",
    "parse_workload",
    "register_strategy",
    "register_workload_scheme",
    "run",
    "spec_key",
    "workload_schemes",
]
