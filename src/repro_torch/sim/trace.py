"""The time-stepped plan executor: programs -> a :class:`TrafficTrace`.

Executes a lowered plan (:mod:`repro_torch.sim.lower`) on a single timeline:

* a **prologue** loads the first subgraph's first weights — one explicit
  per-core DRAM stream segment per ``weight_share_cores`` core (§5.4.2),
* each subgraph runs its elementary operations in schedule order; while it
  computes, the *next* subgraph's first weight load streams in underneath
  (the paper's double-buffered weight prefetch, Fig. 3),
* single-layer block sweeps re-stream their weights at block boundaries,
* on a multi-core plan every DRAM-loaded weight byte is additionally
  broadcast to the ``weight_share_cores - 1`` peer cores over the NoC
  fabric (``noc_bytes`` rides on the step that loads the byte — the fabric
  is concurrent with the DRAM link, so it adds traffic, not time), and
  weight-buffer occupancy tracks the *per-core* residency
  (``weight_resident``), not the full weight bytes.

Time base: each subgraph's steps are scaled so their durations sum to the
analytical subgraph latency ``max(compute, IO)`` — the simulator is a
lowering of the cost model, not a second opinion on it, which is what
makes exact analytical<->simulated cross-validation possible (total DRAM
bytes match the kernel's EMA byte-for-byte, total cycles match
``PlanCost.latency_cycles`` plus the prologue).  Within a subgraph, step
durations are proportional to each step's own ``max(compute, IO)``, so
bursts (block reloads, ramp-up loads) are visible in the profile.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core.cost import AcceleratorConfig, CostKernel, PlanCost
from repro_torch.core.graph import Graph

from .bandwidth import DEFAULT_PERCENTILES, BandwidthProfile, \
    profile_from_steps
from .lower import _even_split, lower_plan

TRACE_FORMAT = "cocco-trace"
# v2: multi-core lowering — per-step/per-subgraph ``noc_bytes``, per-core
# prologue DRAM streams (``core``), and a top-level ``noc`` section with
# aggregate + per-link fabric profiles
# v3: per-tensor occupancy timelines — each compute step carries
# ``occ_tensors`` ([tensor id, bytes] pairs summing exactly to ``occ_act``;
# empty on prologue/weight-only steps)
TRACE_FORMAT_VERSION = 3

PROLOGUE = -1   # TraceStep.subgraph index of the initial weight load
WHOLE_CHIP = -1  # TraceStep.core for steps not tied to one core's stream


@dataclass(frozen=True)
class TraceStep:
    """One timeline step: traffic, duration, and buffer state."""

    subgraph: int        # plan index; PROLOGUE (-1) for the initial load
    step: int            # step index within the subgraph
    t_cycles: float      # start time
    cycles: float        # duration
    act_in: int          # external activation bytes loaded
    act_out: int         # activation bytes stored
    w_in: int            # weight bytes loaded (prefetch + stream)
    occ_act: int         # activation-buffer bytes resident at step end
    occ_w: int           # weight-buffer bytes resident at step end (per core)
    rows: int = 0
    macs: int = 0
    noc_bytes: int = 0   # weight bytes broadcast over the core-to-core fabric
    core: int = WHOLE_CHIP  # owning core of a per-core DRAM stream segment
    # v3: per-tensor activation occupancy at step end — sorted (tensor id,
    # bytes) pairs summing exactly to occ_act; empty on prologue steps
    occ_tensors: Tuple[Tuple[int, int], ...] = ()

    @property
    def dram_in(self) -> int:
        return self.act_in + self.w_in

    @property
    def dram_out(self) -> int:
        return self.act_out

    @property
    def dram_bytes(self) -> int:
        return self.dram_in + self.dram_out


@dataclass(frozen=True)
class SubgraphTrafficSummary:
    """Per-subgraph totals of a trace (the cross-validation unit)."""

    index: int
    nodes: Tuple[int, ...]
    act_in: int
    act_out: int
    w_first: int
    w_stream: int
    stream_blocks: int
    cycles: float
    n_steps: int
    peak_occ_act: int
    peak_occ_w: int
    footprint: int
    region_count: Optional[int]
    region_table_bytes: Optional[int]
    noc_bytes: int = 0   # broadcast bytes of this subgraph's own weights

    @property
    def dram_bytes(self) -> int:
        return self.act_in + self.act_out + self.w_first + self.w_stream


@dataclass
class TrafficTrace:
    """The simulator's output: a timeline plus per-subgraph totals."""

    graph_name: str
    acc: AcceleratorConfig
    groups: List[Tuple[int, ...]]
    out_tile: int
    steps: List[TraceStep]
    subgraphs: List[SubgraphTrafficSummary]
    plan: PlanCost = field(repr=False, default=None)  # analytical companion

    # -- totals ------------------------------------------------------------
    @property
    def total_dram_in(self) -> int:
        return sum(s.dram_in for s in self.steps)

    @property
    def total_dram_out(self) -> int:
        return sum(s.dram_out for s in self.steps)

    @property
    def total_dram_bytes(self) -> int:
        return self.total_dram_in + self.total_dram_out

    @property
    def total_cycles(self) -> float:
        return sum(s.cycles for s in self.steps)

    @property
    def total_noc_bytes(self) -> int:
        return sum(s.noc_bytes for s in self.steps)

    def noc_profile(
        self, percentiles: Sequence[float] = DEFAULT_PERCENTILES,
        links: int = 1,
    ) -> BandwidthProfile:
        """NoC-fabric requirement profile: aggregate (``links=1``) or
        per-link (``links=weight_share_cores`` — the rotation fabric is
        symmetric, so each link carries ``1/links`` of a step's broadcast
        bytes).  The prologue broadcast is excluded from the statistics but
        counts toward totals, mirroring :meth:`bandwidth_profile`."""
        def scaled(b):
            return b if links <= 1 else b / links
        return profile_from_steps(
            ((scaled(s.noc_bytes), s.cycles) for s in self.steps
             if s.subgraph >= 0),
            self.acc.freq_hz, percentiles,
            totals=(scaled(self.total_noc_bytes), self.total_cycles))

    def bandwidth_profile(
        self, percentiles: Sequence[float] = DEFAULT_PERCENTILES,
    ) -> BandwidthProfile:
        # prologue steps are link-bound by construction, so they are
        # excluded from the requirement statistics (peak/percentiles) but
        # still count toward totals and sustained bandwidth — mirroring
        # PlanCost.traffic_segments()/prologue_traffic()
        return profile_from_steps(
            ((s.dram_bytes, s.cycles) for s in self.steps
             if s.subgraph >= 0),
            self.acc.freq_hz, percentiles,
            totals=(self.total_dram_bytes, self.total_cycles))

    # -- serialization (the documented trace JSON schema) ------------------
    def to_dict(self, meta: Optional[Dict[str, Any]] = None,
                include_steps: bool = True) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "format": TRACE_FORMAT,
            "version": TRACE_FORMAT_VERSION,
            "graph": self.graph_name,
            "acc": asdict(self.acc),
            "out_tile": self.out_tile,
            "groups": [list(gr) for gr in self.groups],
            "totals": {
                "dram_in": self.total_dram_in,
                "dram_out": self.total_dram_out,
                "dram_bytes": self.total_dram_bytes,
                "noc_bytes": self.total_noc_bytes,
                "cycles": self.total_cycles,
            },
            "profile": self.bandwidth_profile().to_dict(),
            "noc": {
                "links": self.acc.weight_share_cores,
                "total_bytes": self.total_noc_bytes,
                "aggregate": self.noc_profile().to_dict(),
                "per_link": self.noc_profile(
                    links=self.acc.weight_share_cores).to_dict(),
            },
            "subgraphs": [asdict(sg) for sg in self.subgraphs],
        }
        if include_steps:
            d["steps"] = [asdict(s) for s in self.steps]
        if meta:
            d["meta"] = dict(meta)
        return d

    def to_json(self, meta: Optional[Dict[str, Any]] = None,
                include_steps: bool = True,
                indent: Optional[int] = 2) -> str:
        return json.dumps(self.to_dict(meta=meta,
                                       include_steps=include_steps),
                          indent=indent, sort_keys=True)


def _coalesce(steps: List[TraceStep], limit: int) -> List[TraceStep]:
    """Merge a subgraph's steps down to <= ``limit`` buckets (totals are
    preserved exactly; occupancy takes the bucket's last value)."""
    n = len(steps)
    if n <= limit:
        return steps
    out: List[TraceStep] = []
    start = 0
    for b in range(limit):
        end = ((b + 1) * n) // limit
        chunk = steps[start:end]
        if not chunk:
            continue
        out.append(TraceStep(
            subgraph=chunk[0].subgraph, step=b,
            t_cycles=chunk[0].t_cycles,
            cycles=sum(c.cycles for c in chunk),
            act_in=sum(c.act_in for c in chunk),
            act_out=sum(c.act_out for c in chunk),
            w_in=sum(c.w_in for c in chunk),
            occ_act=chunk[-1].occ_act, occ_w=chunk[-1].occ_w,
            rows=sum(c.rows for c in chunk),
            macs=sum(c.macs for c in chunk),
            noc_bytes=sum(c.noc_bytes for c in chunk),
            core=chunk[0].core,
            occ_tensors=chunk[-1].occ_tensors))
        start = end
    return out


def simulate_plan(
    g: Graph,
    groups: Sequence[Set[int]],
    acc: AcceleratorConfig,
    out_tile: int = 1,
    steps_per_subgraph: Optional[int] = None,
    kernel: Optional[CostKernel] = None,
) -> TrafficTrace:
    """Execute a partition plan on the simulated timeline.

    ``groups`` is the plan in execution order (any infeasible subgraph is
    a :class:`ValueError` — an infeasible plan has no timeline).
    ``steps_per_subgraph`` coalesces each subgraph's row-granular steps
    down to at most that many buckets; coalescing merges traffic and time,
    so every total (and the cross-validation) is resolution-independent.
    """
    programs, plan = lower_plan(g, groups, acc, out_tile=out_tile,
                                kernel=kernel)
    freq = acc.freq_hz
    bpc = acc.dram_bytes_per_cycle
    share = acc.weight_share_cores

    steps: List[TraceStep] = []
    summaries: List[SubgraphTrafficSummary] = []
    t = 0.0

    # prologue: the first subgraph's first weight load streams before any
    # compute — one explicit DRAM stream segment per core (§5.4.2: each
    # core pulls its own shard of the load; single-core plans keep the one
    # step of the v1 schema).  Weight occupancy is *per core*: it climbs by
    # cumulative integer scaling to exactly the per-core residency the
    # analytical kernel charges (``weight_resident``), not the full weight
    # bytes.  Every loaded byte is broadcast to the share - 1 peer cores.
    first0 = programs[0].weight_first
    resident0 = programs[0].cost.weight_resident
    if first0 > 0:
        cum = 0
        for c, shard in enumerate(_even_split(first0, share)):
            if shard <= 0:
                continue
            cum += shard
            cyc = shard / bpc
            steps.append(TraceStep(
                subgraph=PROLOGUE, step=c, t_cycles=t, cycles=cyc,
                act_in=0, act_out=0, w_in=shard, occ_act=0,
                occ_w=(cum * resident0) // first0,
                noc_bytes=(share - 1) * shard, core=c))
            t += cyc

    for i, prog in enumerate(programs):
        n = prog.n_steps
        nxt_first = (programs[i + 1].weight_first
                     if i + 1 < len(programs) else 0)
        nxt_resident = (programs[i + 1].cost.weight_resident
                        if i + 1 < len(programs) else 0)
        prefetch = _even_split(nxt_first, n)
        # raw per-step demand: max(compute, IO); then scale so the subgraph
        # occupies exactly its analytical latency on the timeline
        raw: List[float] = []
        for k, stp in enumerate(prog.steps):
            io = stp.act_in + stp.act_out + stp.w_stream + prefetch[k]
            raw.append(max(stp.macs / acc.macs_per_cycle, io / bpc))
        lat = prog.cost.latency_cycles(acc)
        raw_sum = sum(raw)
        if raw_sum > 0:
            durations = [r * lat / raw_sum for r in raw]
        else:
            # no per-step demand (e.g. a weight-only subgraph whose first
            # load happened in the previous prefetch window): spread the
            # analytical latency evenly so the timeline still spans it
            durations = [lat / n] * n

        own_w = prog.cost.weight_resident     # per-core resident own weights
        pre_cum = 0
        sub_steps: List[TraceStep] = []
        sub_t = t
        for k, stp in enumerate(prog.steps):
            pre_cum += prefetch[k]
            cyc = durations[k]
            w_in = stp.w_stream + prefetch[k]
            # prefetched weights occupy each core at its per-core share of
            # the next subgraph's residency (cumulative integer scaling
            # lands exactly on nxt_resident when the prefetch completes)
            occ_pre = ((pre_cum * nxt_resident) // nxt_first
                       if nxt_first > 0 else 0)
            sub_steps.append(TraceStep(
                subgraph=i, step=k, t_cycles=sub_t, cycles=cyc,
                act_in=stp.act_in, act_out=stp.act_out,
                w_in=w_in,
                occ_act=stp.occ_act, occ_w=own_w + occ_pre,
                rows=stp.rows, macs=stp.macs,
                noc_bytes=(share - 1) * w_in,
                occ_tensors=stp.occ_tensors))
            sub_t += cyc
        if steps_per_subgraph is not None:
            sub_steps = _coalesce(sub_steps, max(1, steps_per_subgraph))
        steps.extend(sub_steps)
        t += lat

        summaries.append(SubgraphTrafficSummary(
            index=i, nodes=prog.nodes,
            act_in=prog.act_in_total, act_out=prog.act_out_total,
            w_first=prog.weight_first, w_stream=prog.weight_stream,
            stream_blocks=prog.stream_blocks,
            cycles=lat, n_steps=len(sub_steps),
            peak_occ_act=prog.peak_occ_act,
            peak_occ_w=own_w + nxt_resident,
            footprint=prog.footprint,
            region_count=prog.region_count,
            region_table_bytes=prog.region_table_bytes,
            noc_bytes=prog.noc_bytes))

    return TrafficTrace(
        graph_name=g.name, acc=acc,
        groups=[tuple(sorted(s)) for s in groups],
        out_tile=out_tile, steps=steps, subgraphs=summaries, plan=plan)
