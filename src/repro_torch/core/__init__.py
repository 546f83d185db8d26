"""Cocco core: graph-level memory scheme + hardware-mapping co-exploration.

The port's copy of ``repro.core``: the same planner host code, with the
``torch`` executor backend in place of the ``jax`` one.
"""

from .cost import (
    GLB_CANDIDATES,
    METRICS,
    SHARED_CANDIDATES,
    WBUF_CANDIDATES,
    AcceleratorConfig,
    CachedEvaluator,
    CostKernel,
    PlanCost,
    SubgraphCost,
    SubgraphStructure,
    TrafficBreakdown,
    compute_structure,
    evaluate_partition,
    evaluate_subgraph,
    finish_cost,
    time_weighted_percentile,
)
from .engine import (
    Executor,
    ProcessExecutor,
    SerialExecutor,
    TorchExecutor,
    VectorExecutor,
    make_executor,
)
from .ga import (
    Genome,
    HWSpace,
    Objective,
    SearchResult,
    evaluate_genomes,
    run_ga,
)
from .graph import FULL, SLIDING, Edge, Graph, Node, sequential_graph
from .memory import (
    FootprintReport,
    OccupancyTracker,
    Region,
    RegionTable,
    build_region_table,
    subgraph_footprint,
)
from .partition import (
    groups_of,
    is_valid,
    normalize,
    partition_of,
    random_partition,
    singleton_partition,
    split_to_fit,
    split_to_fit_batch,
)
from .tiling import SubgraphSchedule, TensorSchedule, derive_schedule

__all__ = [k for k in dir() if not k.startswith("_")]
