"""Lowering: one subgraph -> a row-granular step program.

The analytical kernel (:mod:`repro_torch.core.cost`) gives a subgraph three
traffic sums (``ema_in``/``ema_out``/``ema_w``); the consumption-centric
schedule (:mod:`repro_torch.core.tiling`) gives every resident tensor an update
quantum (``delta`` rows per update, ``upd_num`` updates per elementary
operation).  Lowering composes the two into a :class:`SubgraphProgram`: a
sequence of steps (one per elementary operation) that

* loads each external input tensor row-by-row at its scheduled rate,
* stores each output tensor row-by-row as it is produced,
* re-streams a single-layer subgraph's weights once per row-block sweep
  (block boundaries placed by the analytical block count), and
* accounts buffer occupancy through
  :class:`repro_torch.core.memory.OccupancyTracker` under the ``RegionTable``
  region allocations.

Every byte apportioned across steps comes from an integer cumulative
split, so the per-subgraph sums reproduce the analytical EMA **exactly**
— the invariant :mod:`repro_torch.sim.validate` asserts for whole plans.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core.cost import (
    AcceleratorConfig,
    CostKernel,
    PlanCost,
    SubgraphCost,
    finish_cost,
)
from repro_torch.core.graph import Graph
from repro_torch.core.memory import OccupancyTracker, build_region_table
from repro_torch.core.tiling import derive_schedule


@dataclass(frozen=True)
class StepTraffic:
    """DRAM traffic and state of one elementary operation (one step)."""

    act_in: int          # external activation bytes loaded this step
    act_out: int         # output activation bytes stored this step
    w_stream: int        # weight bytes re-streamed this step (block sweeps)
    macs: int            # MACs issued this step
    rows: int            # internal rows produced this step
    occ_act: int         # activation-buffer bytes resident at step end
    # per-tensor occupancy at step end: sorted (tensor id, bytes) pairs
    # summing exactly to occ_act (trace JSON v3 timelines)
    occ_tensors: Tuple[Tuple[int, int], ...] = ()


@dataclass(frozen=True)
class SubgraphProgram:
    """One subgraph lowered to a deterministic step sequence."""

    nodes: Tuple[int, ...]
    cost: SubgraphCost               # the analytical per-subgraph cost
    steps: Tuple[StepTraffic, ...]
    weight_first: int                # loaded before the subgraph starts
    weight_stream: int               # re-streamed during execution
    stream_blocks: int
    peak_occ_act: int
    footprint: int                   # analytical activation footprint
    region_count: Optional[int]      # RegionTable entries (None: streamed)
    region_table_bytes: Optional[int]
    # §5.4.2 weight broadcast over the core-to-core fabric: every DRAM-
    # loaded weight byte reaches the weight_share_cores - 1 peer cores
    # (== the analytical cost's noc_bytes; zero on a single core)
    noc_bytes: int = 0

    @property
    def n_steps(self) -> int:
        return len(self.steps)

    @property
    def act_in_total(self) -> int:
        return sum(s.act_in for s in self.steps)

    @property
    def act_out_total(self) -> int:
        return sum(s.act_out for s in self.steps)

    @property
    def weight_total(self) -> int:
        return self.weight_first + self.weight_stream


def _even_split(total: int, n: int) -> List[int]:
    """Apportion ``total`` over ``n`` slots by cumulative integer rounding
    (sums exactly to ``total``; deterministic)."""
    if n <= 0:
        return []
    out, prev = [], 0
    for k in range(1, n + 1):
        cur = (total * k) // n
        out.append(cur - prev)
        prev = cur
    return out


def lower_subgraph(
    g: Graph,
    nodes: Set[int],
    acc: AcceleratorConfig,
    out_tile: int = 1,
    kernel: Optional[CostKernel] = None,
) -> SubgraphProgram:
    """Lower one subgraph to its step program (raises on infeasibility)."""
    fs = frozenset(nodes)
    kernel = kernel or CostKernel(g, out_tile=out_tile)
    st = kernel.structure(fs)
    sc = finish_cost(st, acc)
    if not sc.feasible:
        raise ValueError(
            f"cannot lower infeasible subgraph {sorted(nodes)}: {sc.reason}")
    sched = derive_schedule(g, set(nodes), out_tile=out_tile)
    brk = sc.traffic_breakdown()

    # rows each tensor gains per elementary operation, and how many ops the
    # slowest tensor needs to complete (>= the schedule's sink-driven count,
    # so every external load and output store finishes inside the program)
    rate = {t: max(1, ts.delta * ts.upd_num) for t, ts in
            sched.tensors.items()}
    n_steps = max(math.ceil(g.nodes[t].out_len / rate[t])
                  for t in sched.tensors)

    ext = sorted(t for t, ts in sched.tensors.items() if ts.external)
    outs = {e.src for e in g.boundary_out(nodes)}
    outs |= {v for v in nodes if g.nodes[v].is_output}
    outs = sorted(outs)
    internal = sorted(nodes)

    # weight re-streaming: block b of a single-layer sweep starts at the
    # step where its row block begins; block 0 is the prefetched first load
    stream_at: Dict[int, int] = {}
    if brk.stream_blocks > 1:
        per_block = brk.weight_stream // (brk.stream_blocks - 1)
        left = brk.weight_stream
        for b in range(1, brk.stream_blocks):
            k = (b * n_steps) // brk.stream_blocks
            bts = per_block if b < brk.stream_blocks - 1 else left
            stream_at[k] = stream_at.get(k, 0) + bts
            left -= bts

    rows_total = sum(g.nodes[v].out_len for v in internal)
    occ = OccupancyTracker.from_schedule(g, sched)
    filled: Dict[int, int] = {t: 0 for t in sched.tensors}
    steps: List[StepTraffic] = []
    rows_cum = 0
    macs_cum = 0
    for k in range(n_steps):
        produced: Dict[int, int] = {}
        for t in sched.tensors:
            inc = min(rate[t], g.nodes[t].out_len - filled[t])
            if inc > 0:
                produced[t] = inc
                filled[t] += inc
        act_in = sum(produced.get(t, 0) * g.nodes[t].line_bytes for t in ext)
        act_out = sum(produced.get(t, 0) * g.nodes[t].line_bytes
                      for t in outs)
        rows_k = sum(produced.get(v, 0) for v in internal)
        rows_cum += rows_k
        macs_next = (sc.macs * rows_cum) // max(rows_total, 1)
        occ_bytes = occ.advance(produced)
        occ_tensors = tuple(sorted(
            (t, b) for t, b in occ.resident_by_tensor().items() if b > 0))
        steps.append(StepTraffic(
            act_in=act_in, act_out=act_out,
            w_stream=stream_at.get(k, 0),
            macs=macs_next - macs_cum, rows=rows_k, occ_act=occ_bytes,
            occ_tensors=occ_tensors))
        macs_cum = macs_next

    # region-table layout (the paper's buffer region manager); a streamed
    # single layer deliberately exceeds the buffer, so it has no static
    # layout — the block sweep reuses one MAIN region
    region_count: Optional[int] = None
    region_bytes: Optional[int] = None
    try:
        table = build_region_table(g, set(nodes), acc.glb_bytes,
                                   out_tile=out_tile, schedule=sched)
        region_count = len(table.regions)
        region_bytes = table.table_bytes()
    except MemoryError:
        pass

    return SubgraphProgram(
        nodes=tuple(internal), cost=sc, steps=tuple(steps),
        weight_first=brk.weight_first, weight_stream=brk.weight_stream,
        stream_blocks=brk.stream_blocks, peak_occ_act=occ.peak_bytes,
        footprint=sc.footprint, region_count=region_count,
        region_table_bytes=region_bytes,
        noc_bytes=(acc.weight_share_cores - 1)
        * (brk.weight_first + brk.weight_stream))


def lower_plan(
    g: Graph,
    groups: Sequence[Set[int]],
    acc: AcceleratorConfig,
    out_tile: int = 1,
    kernel: Optional[CostKernel] = None,
) -> Tuple[List[SubgraphProgram], PlanCost]:
    """Lower a whole plan; returns the programs plus the analytical cost."""
    if not groups:
        raise ValueError("cannot lower an empty plan")
    kernel = kernel or CostKernel(g, out_tile=out_tile)
    programs = [lower_subgraph(g, set(s), acc, out_tile=out_tile,
                               kernel=kernel) for s in groups]
    plan = PlanCost(subgraphs=[p.cost for p in programs], acc=acc)
    return programs, plan
