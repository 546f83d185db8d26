"""Accelerator cost model (paper §5.1.2): a Simba-like NPU core.

4x4 PEs x 8x8 MACs = 1024 MACs/cycle @ 1 GHz (2 TOPS), a global (activation)
buffer and a weight buffer (or one shared buffer), 16 GB/s DRAM, 12.5 pJ/bit
DRAM energy.  Weights of the *next* subgraph are prefetched during the current
subgraph's compute; subgraph latency = max(compute cycles, IO cycles).

Per-subgraph external memory access (EMA):
  * input activations crossing into the subgraph      (loaded once — full reuse),
  * output activations needed outside                  (stored once),
  * weights of the subgraph's layers                   (loaded once).

Feasibility rules (documented deviations in DESIGN.md §8):
  * activation footprint (consumption-centric allocations, incl. external
    input buffers) must fit the global buffer,
  * multi-layer subgraphs keep all member weights resident: sum of weights
    must fit the weight buffer; single-layer subgraphs may stream weights
    (reloading them once per row-block sweep if the input cannot be held).

Energy = DRAM traffic + buffer accesses (capacity-dependent pJ/B from an
ARM-memory-compiler-style sqrt model) + MAC energy.
"""

from __future__ import annotations

import math
import os
import time
from contextlib import contextmanager
from dataclasses import dataclass, field, replace as dataclass_replace
from typing import (
    Any,
    Dict,
    Iterator,
    List,
    Mapping,
    Optional,
    Sequence,
    Set,
    Tuple,
)

from repro_torch.obs import recorder as obs

from .graph import FULL, Graph
from .memory import subgraph_footprint
from .tiling import derive_schedule

KB = 1024
MB = 1024 * 1024

# every metric PlanCost.metric / Objective accept; "bandwidth" is the
# percentile of the plan's traffic-segment profile (see traffic_segments);
# "noc_p95" / "noc_link_peak" are the multi-core broadcast-fabric analogues
# (see noc_segments) — zero whenever weight_share_cores == 1
METRICS: Tuple[str, ...] = ("ema", "energy", "latency", "bandwidth",
                            "noc_p95", "noc_link_peak")
BANDWIDTH_PERCENTILE = 95.0

# reason prefix _stream_single_layer stamps on a streamed subgraph; the
# single definition both writers and readers (traffic_breakdown) share —
# the word is part of serialized artifacts, so change it only with a
# golden regeneration
STREAM_REASON = "streamed"


@dataclass(frozen=True)
class AcceleratorConfig:
    """Hardware point being evaluated (the DSE genome's HW half)."""

    glb_bytes: int = 1 * MB              # global (activation) buffer
    wbuf_bytes: int = int(1.125 * MB)    # weight buffer
    shared: bool = False                 # one buffer for acts + weights
    macs_per_cycle: int = 1024           # 4x4 PEs x 8x8 MACs
    freq_hz: float = 1e9
    dram_bytes_per_sec: float = 16e9
    e_dram_pj_per_byte: float = 100.0    # 12.5 pJ/bit
    e_mac_pj: float = 0.05               # INT8 MAC @ 12nm
    n_cores: int = 1
    e_noc_pj_per_byte: float = 2.0       # core-to-core crossbar (Arteris-like)
    weight_share_cores: int = 1          # §5.4.2: cores hold 1/n of weights

    def __post_init__(self) -> None:
        # fail typos/garbage at construction (like Objective.metric): the
        # kernel used to clamp a zero/negative share with max(share, 1),
        # silently turning a config error into single-core arithmetic
        if self.weight_share_cores < 1:
            raise ValueError(
                f"weight_share_cores must be >= 1, got "
                f"{self.weight_share_cores}; use 1 for a single core "
                f"(no weight sharing)")
        if self.n_cores < 1:
            raise ValueError(
                f"n_cores must be >= 1, got {self.n_cores}")

    @property
    def buf_size_total(self) -> int:
        return self.glb_bytes if self.shared else self.glb_bytes + self.wbuf_bytes

    def sram_pj_per_byte(self, capacity_bytes: int) -> float:
        """Access energy grows ~sqrt(capacity) (bank/wire scaling)."""
        return 0.2 + 0.25 * math.sqrt(max(capacity_bytes, 1) / (64 * KB))

    @property
    def dram_bytes_per_cycle(self) -> float:
        return self.dram_bytes_per_sec / self.freq_hz


# paper's search grids (§5.3.1)
GLB_CANDIDATES = [k * KB for k in range(128, 2048 + 1, 64)]
WBUF_CANDIDATES = [k * KB for k in range(144, 2304 + 1, 72)]
SHARED_CANDIDATES = [k * KB for k in range(128, 3072 + 1, 64)]


@dataclass(frozen=True)
class TrafficBreakdown:
    """How one subgraph's DRAM traffic decomposes over its lifetime.

    ``weight_first`` is loaded once before the subgraph starts (and is what
    the next-subgraph weight prefetch moves under the previous subgraph's
    compute); ``weight_stream`` is re-streamed *during* execution by a
    single-layer row-block sweep (``stream_blocks`` sweeps total, 1 = no
    streaming).  Invariant: ``weight_first + weight_stream == ema_w``.
    This is the per-subgraph hook :mod:`repro_torch.sim` lowers into a timeline.
    """

    ema_in: int
    ema_out: int
    weight_first: int
    weight_stream: int
    stream_blocks: int

    @property
    def total(self) -> int:
        return self.ema_in + self.ema_out + self.weight_first \
            + self.weight_stream


def time_weighted_percentile(pairs: Sequence[Tuple[float, float]],
                             p: float) -> float:
    """Percentile ``p`` (0..100) of ``value`` weighted by ``weight``.

    ``pairs`` is (value, weight); zero-weight pairs are ignored.  Returns
    the smallest value v such that at least p% of the total weight lies at
    values <= v — the step-function percentile the trace simulator and the
    plan-level bandwidth metric share, so both layers agree exactly.
    """
    live = [(v, w) for v, w in pairs if w > 0]
    if not live:
        return 0.0
    live.sort(key=lambda vw: vw[0])
    total = sum(w for _, w in live)
    acc = 0.0
    for v, w in live:
        acc += w
        if acc >= (p / 100.0) * total - 1e-12 * total:
            return v
    return live[-1][0]


@dataclass
class SubgraphCost:
    nodes: Tuple[int, ...]
    ema_in: int = 0
    ema_out: int = 0
    ema_w: int = 0
    macs: int = 0
    footprint: int = 0
    weight_resident: int = 0
    glb_access_bytes: int = 0
    wbuf_access_bytes: int = 0
    # §5.4.2 multi-core weight sharing: bytes rotated across the core-to-core
    # fabric so every core sees the full weight set while buffering only its
    # 1/n shard — (weight_share_cores - 1) * ema_w, zero on a single core
    noc_bytes: int = 0
    feasible: bool = True
    reason: str = ""

    @property
    def ema_total(self) -> int:
        return self.ema_in + self.ema_out + self.ema_w

    def compute_cycles(self, acc: AcceleratorConfig) -> float:
        return self.macs / acc.macs_per_cycle

    def io_cycles(self, acc: AcceleratorConfig) -> float:
        return self.ema_total / acc.dram_bytes_per_cycle

    def latency_cycles(self, acc: AcceleratorConfig) -> float:
        return max(self.compute_cycles(acc), self.io_cycles(acc))

    def traffic_breakdown(self) -> TrafficBreakdown:
        """Split ``ema_*`` into the phases the trace simulator executes.

        Streaming is recovered from the cost itself (``ema_w`` is
        ``weight_resident * n_blocks`` when ``_stream_single_layer`` ran),
        so round-tripped plans decompose identically to fresh ones.
        """
        streamed = self.reason.startswith(STREAM_REASON)
        if streamed and self.weight_resident > 0:
            first = self.weight_resident
            blocks = self.ema_w // self.weight_resident
        else:
            first = self.ema_w
            blocks = 1
        return TrafficBreakdown(
            ema_in=self.ema_in, ema_out=self.ema_out, weight_first=first,
            weight_stream=self.ema_w - first, stream_blocks=max(blocks, 1))

    def energy_pj(self, acc: AcceleratorConfig) -> float:
        if acc.shared:
            e_glb = acc.sram_pj_per_byte(acc.glb_bytes)
            e_w = e_glb
        else:
            e_glb = acc.sram_pj_per_byte(acc.glb_bytes)
            e_w = acc.sram_pj_per_byte(acc.wbuf_bytes)
        return (
            self.ema_total * acc.e_dram_pj_per_byte
            + self.glb_access_bytes * e_glb
            + self.wbuf_access_bytes * e_w
            + self.noc_bytes * acc.e_noc_pj_per_byte
            + self.macs * acc.e_mac_pj
        )


@dataclass
class PlanCost:
    """Aggregate cost of a full partition plan (paper Formulas 1 & 2)."""

    subgraphs: List[SubgraphCost]
    acc: AcceleratorConfig

    @property
    def feasible(self) -> bool:
        return all(s.feasible for s in self.subgraphs)

    @property
    def ema_total(self) -> int:
        return sum(s.ema_total for s in self.subgraphs)

    @property
    def energy_pj(self) -> float:
        return sum(s.energy_pj(self.acc) for s in self.subgraphs)

    @property
    def latency_cycles(self) -> float:
        return sum(s.latency_cycles(self.acc) for s in self.subgraphs)

    @property
    def latency_s(self) -> float:
        return self.latency_cycles / self.acc.freq_hz

    def avg_bandwidth(self) -> float:
        """bytes/s sustained over the whole network."""
        lat = self.latency_s
        return self.ema_total / lat if lat > 0 else 0.0

    def peak_bandwidth(self) -> float:
        """max segment bandwidth requirement over the plan's timeline
        (paper Fig. 3 caption: act IO + the next subgraph's weight prefetch
        over each subgraph's latency, plus any single-layer block
        re-streaming; the link-bound weight prologue is excluded).  One
        timeline model with :meth:`traffic_segments`, so this equals the
        trace simulator's peak at one-step-per-subgraph resolution by
        construction."""
        freq = self.acc.freq_hz
        return max((bytes_ / cycles * freq
                    for bytes_, cycles in self.traffic_segments()
                    if cycles > 0), default=0.0)

    def prologue_traffic(self) -> Tuple[int, float]:
        """``(bytes, cycles)`` of the initial weight load before subgraph 0.

        The prologue streams the first subgraph's resident weights at the
        DRAM link rate with nothing to overlap, so its duration is defined
        *by* the interface rate — its bandwidth is the link rate by
        construction and carries no plan-dependent requirement signal,
        which is why it is excluded from :meth:`traffic_segments` (it still
        counts toward totals and sustained bandwidth).
        """
        if not self.subgraphs:
            return (0, 0.0)
        first0 = self.subgraphs[0].traffic_breakdown().weight_first
        return (first0, first0 / self.acc.dram_bytes_per_cycle)

    def traffic_segments(self) -> List[Tuple[int, float]]:
        """``(dram_bytes, duration_cycles)`` per bandwidth-requirement
        segment: one per subgraph.

        Each segment's duration is the analytical subgraph latency and its
        bytes are the activations crossing DRAM, any single-layer weight
        re-streaming, and the *next* subgraph's prefetched weights
        (double-buffered under this subgraph's compute, paper Fig. 3).
        The weight prologue is deliberately excluded — it is link-bound by
        construction (see :meth:`prologue_traffic`).  This is exactly what
        :func:`repro_torch.sim.simulate_plan` produces when its row-granular
        steps are coalesced to one step per subgraph — the trace layer's
        profile statistics pin that equivalence.
        """
        segs: List[Tuple[int, float]] = []
        subs = self.subgraphs
        for i, s in enumerate(subs):
            b = s.traffic_breakdown()
            nxt = (subs[i + 1].traffic_breakdown().weight_first
                   if i + 1 < len(subs) else 0)
            segs.append((b.ema_in + b.ema_out + b.weight_stream + nxt,
                         s.latency_cycles(self.acc)))
        return segs

    def bandwidth_percentile(self, p: float = BANDWIDTH_PERCENTILE) -> float:
        """Time-weighted percentile of segment bandwidth, in bytes/s."""
        freq = self.acc.freq_hz
        pairs = [(bytes_ / cycles * freq, cycles)
                 for bytes_, cycles in self.traffic_segments() if cycles > 0]
        return time_weighted_percentile(pairs, p)

    @property
    def noc_total(self) -> int:
        """Total weight-broadcast bytes over the core-to-core fabric."""
        return sum(s.noc_bytes for s in self.subgraphs)

    def noc_segments(self) -> List[Tuple[int, float]]:
        """``(noc_bytes, duration_cycles)`` per requirement segment: one per
        subgraph, on the *same* timeline as :meth:`traffic_segments`.

        A weight byte crosses the fabric when it arrives from DRAM, so
        segment ``i`` broadcasts its own re-streamed blocks plus the next
        subgraph's prefetched first load — ``(share - 1) *`` the weight
        bytes of the matching DRAM segment.  The prologue broadcast (the
        first subgraph's initial weights) is excluded for the same reason
        the DRAM prologue is (see :meth:`prologue_traffic`); it still
        counts toward :attr:`noc_total`.
        """
        share = self.acc.weight_share_cores
        segs: List[Tuple[int, float]] = []
        subs = self.subgraphs
        for i, s in enumerate(subs):
            b = s.traffic_breakdown()
            nxt = (subs[i + 1].traffic_breakdown().weight_first
                   if i + 1 < len(subs) else 0)
            segs.append(((share - 1) * (b.weight_stream + nxt),
                         s.latency_cycles(self.acc)))
        return segs

    def noc_percentile(self, p: float = BANDWIDTH_PERCENTILE) -> float:
        """Time-weighted percentile of aggregate NoC bandwidth, bytes/s."""
        freq = self.acc.freq_hz
        pairs = [(bytes_ / cycles * freq, cycles)
                 for bytes_, cycles in self.noc_segments() if cycles > 0]
        return time_weighted_percentile(pairs, p)

    def noc_link_peak(self) -> float:
        """Peak *per-link* NoC bandwidth over the timeline, in bytes/s.

        The rotation fabric is symmetric over ``weight_share_cores`` links
        (each core forwards its shard to one neighbour per hop), so a
        segment's broadcast bytes spread evenly: per link, ``bytes /
        share``.
        """
        share = self.acc.weight_share_cores
        freq = self.acc.freq_hz
        return max((bytes_ / share / cycles * freq
                    for bytes_, cycles in self.noc_segments()
                    if cycles > 0), default=0.0)

    def metric(self, name: str) -> float:
        if name == "ema":
            return float(self.ema_total)
        if name == "energy":
            return self.energy_pj
        if name == "latency":
            return self.latency_cycles
        if name == "bandwidth":
            return self.bandwidth_percentile()
        if name == "noc_p95":
            return self.noc_percentile(95.0)
        if name == "noc_link_peak":
            return self.noc_link_peak()
        raise ValueError(
            f"unknown plan metric {name!r}; valid metrics: "
            f"{', '.join(METRICS)}")


# ---------------------------------------------------------------------------
# the pure cost kernel
# ---------------------------------------------------------------------------
#
# A (frozenset(nodes), hardware-point) query is a side-effect-free function of
# the graph, split into two pure halves so batched executors can exploit the
# split (see core/engine.py):
#
#   compute_structure(g, nodes, out_tile)  — the expensive, hardware-
#       independent half: EMA sums, schedule derivation, footprint, on-chip
#       access traffic.  Depends only on the node set (and out_tile).
#   finish_cost(structure, acc)            — the cheap, hardware-dependent
#       half: feasibility vs the buffer capacities, single-layer weight
#       streaming, multi-core weight sharing.  Pure elementwise arithmetic,
#       so a whole batch vectorizes (engine.VectorExecutor).
#
# evaluate_subgraph == finish_cost(compute_structure(...), acc) exactly.


@dataclass(frozen=True)
class SubgraphStructure:
    """Hardware-independent half of a subgraph's cost (pure in the node set).

    ``sched_error`` carries the ``derive_schedule`` failure message when the
    subgraph has no consumption-centric schedule (then every hardware point
    is infeasible and the remaining fields stay at their defaults).
    """

    nodes: Tuple[int, ...]
    macs: int = 0
    weight_total: int = 0
    ema_in: int = 0
    ema_out: int = 0
    footprint: int = 0
    glb_access_bytes: int = 0
    sched_error: Optional[str] = None


def compute_structure(g: Graph, nodes: Set[int],
                      out_tile: int = 1) -> SubgraphStructure:
    """Hardware-independent analysis of one subgraph (pure function)."""
    nodes = set(nodes)
    ntuple = tuple(sorted(nodes))
    macs = sum(g.nodes[v].macs for v in nodes)
    weight_total = sum(g.nodes[v].weight_bytes for v in nodes)

    # ---- EMA ------------------------------------------------------------
    ext_in = {e.src for e in g.boundary_in(nodes)}
    ema_in = sum(g.nodes[t].out_bytes for t in ext_in)
    out_tensors = {e.src for e in g.boundary_out(nodes)}
    out_tensors |= {v for v in nodes if g.nodes[v].is_output}
    ema_out = sum(g.nodes[t].out_bytes for t in out_tensors)

    # ---- schedule + footprint -------------------------------------------
    try:
        sched = derive_schedule(g, nodes, out_tile=out_tile)
    except ValueError as err:
        return SubgraphStructure(nodes=ntuple, macs=macs,
                                 weight_total=weight_total,
                                 ema_in=ema_in, ema_out=ema_out,
                                 sched_error=str(err))
    fp = subgraph_footprint(g, nodes, schedule=sched)

    # ---- on-chip access traffic ------------------------------------------
    # each produced byte written once; each byte read ~F/s times per consumer
    glb = 0
    for t, ts in sched.tensors.items():
        b = g.nodes[t].out_bytes
        glb += b  # write (from DRAM or from PE)
        for e in g.out_edges(t):
            if e.dst in nodes:
                amp = (e.F / e.s) if e.kind != FULL else 1.0
                glb += int(b * amp)
    return SubgraphStructure(nodes=ntuple, macs=macs,
                             weight_total=weight_total,
                             ema_in=ema_in, ema_out=ema_out,
                             footprint=fp.total_bytes, glb_access_bytes=glb)


def finish_cost(st: SubgraphStructure, acc: AcceleratorConfig) -> SubgraphCost:
    """Hardware-dependent half: capacities, streaming, weight sharing.

    Pure arithmetic in ``st``'s fields and ``acc``'s capacities — the
    branch structure here is what ``engine.VectorExecutor`` vectorizes.
    """
    sc = SubgraphCost(nodes=st.nodes, macs=st.macs,
                      weight_resident=st.weight_total,
                      ema_in=st.ema_in, ema_out=st.ema_out,
                      ema_w=st.weight_total)
    if st.sched_error is not None:
        sc.feasible = False
        sc.reason = f"schedule: {st.sched_error}"
        sc.noc_bytes = (acc.weight_share_cores - 1) * sc.ema_w
        return sc
    sc.footprint = st.footprint

    glb_cap = acc.glb_bytes
    wbuf_cap = acc.glb_bytes if acc.shared else acc.wbuf_bytes
    # multi-core weight sharing (§5.4.2): each core buffers 1/n of the
    # weights (construction validates weight_share_cores >= 1)
    sc.weight_resident = sc.weight_resident // acc.weight_share_cores
    single = len(st.nodes) == 1
    if acc.shared:
        if sc.footprint + sc.weight_resident > glb_cap:
            if not single:
                sc.feasible = False
                sc.reason = "shared buffer overflow"
            else:
                _stream_single_layer(sc, glb_cap)
    else:
        if sc.footprint > glb_cap:
            if not single:
                sc.feasible = False
                sc.reason = "global buffer overflow"
            else:
                _stream_single_layer(sc, glb_cap)
        if sc.feasible and not single and sc.weight_resident > wbuf_cap:
            sc.feasible = False
            sc.reason = "weight buffer overflow"
        if sc.feasible and single and sc.weight_resident > wbuf_cap:
            pass  # single layer streams weights (already loaded once)

    sc.glb_access_bytes = st.glb_access_bytes
    sc.wbuf_access_bytes = sc.weight_resident  # one streaming pass per sweep
    # §5.4.2 NoC charge: every DRAM-loaded weight byte (ema_w, *after* any
    # streaming resolution — a streamed sweep rotates each re-loaded block
    # too) crosses the fabric to the weight_share_cores - 1 peer cores
    sc.noc_bytes = (acc.weight_share_cores - 1) * sc.ema_w
    return sc


def evaluate_subgraph(
    g: Graph,
    nodes: Set[int],
    acc: AcceleratorConfig,
    consumers_outside: Optional[Dict[int, int]] = None,
    out_tile: int = 1,
) -> SubgraphCost:
    """Cost one subgraph. ``consumers_outside[t]`` = number of later subgraphs
    reading tensor t (re-reads cost EMA each time; charged at the reader)."""
    return finish_cost(compute_structure(g, nodes, out_tile=out_tile), acc)


def _stream_single_layer(sc: SubgraphCost, glb_cap: int) -> None:
    """Single layer whose line-buffer footprint exceeds the buffer: sweep the
    output in row blocks; weights are re-streamed once per block."""
    n_blocks = max(1, math.ceil(sc.footprint / max(glb_cap, 1)))
    sc.ema_w = sc.weight_resident * n_blocks
    sc.footprint = min(sc.footprint, glb_cap)
    sc.reason = f"{STREAM_REASON} in {n_blocks} blocks"


# canonical memoization default: on everywhere, disabled only for honest
# before/after measurement (REPRO_STRUCT_CANON=0)
_CANON_ENV = "REPRO_STRUCT_CANON"


def canonical_structure_key(g: Graph, nodes: Set[int],
                            out_tile: int = 1) -> Tuple:
    """Content fingerprint of a subgraph query (hashable, label-free).

    Two node sets map to the same key iff relabeling each set's nodes by
    ascending index (internal nodes to ``0..k-1``, external producers to
    ``0..m-1``) yields identical structures over every field
    :func:`compute_structure` reads:

    * per internal node, in sorted-index order:
      ``(out_len, line_bytes, weight_bytes, macs, writes_out)`` where
      ``writes_out`` folds ``is_output`` with "has a consumer outside the
      set" (their union is what feeds ``ema_out``);
    * internal edges as ``(src', dst', F, s, kind)`` with relabeled
      endpoints, sorted;
    * per external producer, in sorted-index order:
      ``(out_len, line_bytes)`` (what ``ema_in``/footprint read);
    * external in-edges as ``(producer', dst', F, s, kind)``, sorted;
    * ``out_tile``.

    Sorted-index relabeling is order-preserving, and every stage of
    :func:`~repro_torch.core.tiling.derive_schedule` is a well-founded recursion
    on consumers (stage 2) or a unique co-prime rate solution (stage 3), so
    equal keys imply field-for-field equal structures up to the ``nodes``
    tuple — the property the canonical memo in :class:`CostKernel` relies
    on and ``tests/test_canonical_structure.py`` fuzzes.  The one
    label-*dependent* output, a ``sched_error`` message (it embeds concrete
    node indices), is excluded from canonical caching by the kernel.
    """
    ntuple = tuple(sorted(nodes))
    nset = set(ntuple)
    rel = {v: i for i, v in enumerate(ntuple)}
    node_sig: List[Tuple] = []
    int_edges: List[Tuple] = []
    ext_cons: Dict[int, List[Tuple]] = {}
    for v in ntuple:
        nd = g.nodes[v]
        writes_out = nd.is_output
        if not writes_out:
            for e in g.out_edges(v):
                if e.dst not in nset:
                    writes_out = True
                    break
        node_sig.append((nd.out_len, nd.line_bytes, nd.weight_bytes,
                         nd.macs, writes_out))
        for e in g.in_edges(v):
            if e.src in nset:
                int_edges.append((rel[e.src], rel[v], e.F, e.s, e.kind))
            else:
                ext_cons.setdefault(e.src, []).append(
                    (rel[v], e.F, e.s, e.kind))
    ext_sig: List[Tuple] = []
    ext_edges: List[Tuple] = []
    for j, p in enumerate(sorted(ext_cons)):
        nd = g.nodes[p]
        ext_sig.append((nd.out_len, nd.line_bytes))
        for tail in sorted(ext_cons[p]):
            ext_edges.append((j,) + tail)
    int_edges.sort()
    return (out_tile, tuple(node_sig), tuple(int_edges),
            tuple(ext_sig), tuple(ext_edges))


class CostKernel:
    """The pure evaluation kernel: graph + out_tile + a tiered structure memo.

    ``cost(nodes, acc)`` is a deterministic, side-effect-free function of
    its arguments; the only state here is memoization of
    :func:`compute_structure` (itself pure), shared by every executor
    backend.  Worker processes hold their own ``CostKernel`` and stay warm
    across batches.

    The memo has up to three tiers, consulted in order:

    1. **raw** — exact ``frozenset(nodes)`` key (the original memo);
    2. **canonical** — :func:`canonical_structure_key` content fingerprint,
       so isomorphic subgraphs (the repeated blocks of ``tpu:``/``netlib:``
       models, GA mutation motifs) share one ``derive_schedule`` call.  A
       canonical hit re-stamps ``SubgraphStructure.nodes`` with the query's
       own tuple, so results stay bitwise-identical to per-node-set
       evaluation.  Structures with a ``sched_error`` are cached *only* by
       raw key — the error message embeds concrete node indices;
    3. **disk** (optional) — a :class:`~repro_torch.core.structcache.
       StructureCache` warming the canonical tier across processes and
       runs, gated like the result store.

    Canonical memoization is on by default; set ``REPRO_STRUCT_CANON=0``
    (or ``canonical=False``) to disable it for before/after measurement.
    """

    def __init__(self, g: Graph, out_tile: int = 1,
                 canonical: Optional[bool] = None,
                 struct_cache: Optional[Any] = None) -> None:
        self.g = g
        self.out_tile = out_tile
        if canonical is None:
            canonical = os.environ.get(_CANON_ENV, "1") != "0"
        self.canonical = bool(canonical)
        self.struct_cache = struct_cache
        self._structures: Dict[frozenset, SubgraphStructure] = {}
        self._canon: Dict[Tuple, SubgraphStructure] = {}
        # profiling counters (--profile surfaces these via the evaluator)
        self.structure_raw_hits = 0
        self.structure_canon_hits = 0
        self.structure_disk_hits = 0
        self.structure_misses = 0
        self.structure_merged = 0     # canonical entries adopted from peers
        self.structure_time_s = 0.0   # wall time inside compute_structure

    def structure(self, nodes: frozenset) -> SubgraphStructure:
        st = self._structures.get(nodes)
        if st is not None:
            self.structure_raw_hits += 1
            return st
        key: Optional[Tuple] = None
        if self.canonical:
            key = canonical_structure_key(self.g, nodes, self.out_tile)
            st = self._canon.get(key)
            if st is None and self.struct_cache is not None:
                st = self.struct_cache.get(key)
                if st is not None:
                    self.structure_disk_hits += 1
                    self._canon[key] = st
            elif st is not None:
                self.structure_canon_hits += 1
            if st is not None:
                st = dataclass_replace(st, nodes=tuple(sorted(nodes)))
                self._structures[nodes] = st
                return st
        t0 = time.perf_counter()
        st = compute_structure(self.g, set(nodes), out_tile=self.out_tile)
        self.structure_time_s += time.perf_counter() - t0
        self.structure_misses += 1
        self._structures[nodes] = st
        if key is not None and st.sched_error is None:
            self._canon[key] = st
            if self.struct_cache is not None:
                self.struct_cache.put(key, st)
        return st

    def cost(self, nodes: frozenset, acc: AcceleratorConfig) -> SubgraphCost:
        return finish_cost(self.structure(nodes), acc)

    def canon_snapshot(self) -> Dict[Tuple, SubgraphStructure]:
        """Picklable copy of the canonical tier (cross-process shipping)."""
        return dict(self._canon)

    def merge_canon(
            self, entries: Mapping[Tuple, SubgraphStructure]) -> int:
        """Adopt canonical entries from a peer kernel (worker join).

        Existing keys win — the kernel is deterministic, so both sides hold
        structures equal up to the ``nodes`` stamp, which every canonical
        hit re-stamps anyway.  Returns the number of new entries.
        """
        added = 0
        canon = self._canon
        for key, st in entries.items():
            if key not in canon:
                canon[key] = st
                added += 1
        self.structure_merged += added
        return added


def evaluate_partition(
    g: Graph,
    groups: Sequence[Set[int]],
    acc: AcceleratorConfig,
    out_tile: int = 1,
) -> PlanCost:
    """Cost a full plan: ``groups`` in execution order."""
    # count cross-subgraph readers per tensor (multi-reader tensors are
    # re-loaded by each reading subgraph; charged naturally since each group's
    # ema_in includes every external tensor it touches)
    subs = [evaluate_subgraph(g, set(s), acc, out_tile=out_tile)
            for s in groups]
    return PlanCost(subgraphs=subs, acc=acc)


class CachedEvaluator:
    """Memoizes per-subgraph costs across a whole search run.

    The schedule/footprint half depends only on the node set; the feasibility/
    streaming half also depends on the accelerator config, so the cache key is
    (frozenset(nodes), glb, wbuf, shared).  GA populations re-evaluate mostly
    unchanged subgraphs, giving ~2 orders of magnitude speedup.

    The evaluator is cache + counters only; *how* misses are computed is the
    ``executor``'s job (:mod:`repro_torch.core.engine`): ``serial`` evaluates them
    inline through the pure :class:`CostKernel`, ``process`` shards a batch
    over worker processes, ``vector`` batches the hardware-dependent
    arithmetic through NumPy.  Every backend returns identical costs (the
    kernel is deterministic), so search results do not depend on the backend.
    """

    def __init__(self, g: Graph, out_tile: int = 1,
                 executor: Optional["Executor"] = None,
                 canonical: Optional[bool] = None,
                 struct_cache: Optional[Any] = None) -> None:
        self.g = g
        self.out_tile = out_tile
        self.kernel = CostKernel(g, out_tile=out_tile, canonical=canonical,
                                 struct_cache=struct_cache)
        self._executor = executor
        self._cache: Dict[Tuple, SubgraphCost] = {}
        self.evaluations = 0   # cache misses (true cost-model invocations)
        self.lookups = 0
        self.merged = 0        # entries adopted from other evaluators
        self._run_scopes: List[Set[Tuple]] = []

    @property
    def executor(self) -> "Executor":
        if self._executor is None:
            from .engine import SerialExecutor  # deferred: engine imports us
            self._executor = SerialExecutor()
        return self._executor

    def close(self) -> None:
        """Release executor resources (worker pools); the cache survives."""
        if self._executor is not None:
            self._executor.close()

    def _key(self, nodes: frozenset, acc: AcceleratorConfig) -> Tuple:
        return (nodes, acc.glb_bytes, acc.wbuf_bytes, acc.shared,
                acc.weight_share_cores)

    def subgraph(self, nodes: Set[int], acc: AcceleratorConfig) -> SubgraphCost:
        fs = frozenset(nodes)
        key = self._key(fs, acc)
        self.lookups += 1
        for scope in self._run_scopes:
            scope.add(key)
        hit = self._cache.get(key)
        if hit is None:
            hit = self.kernel.cost(fs, acc)
            self._cache[key] = hit
            self.evaluations += 1
        return hit

    def evaluate_batch(
        self, queries: Sequence[Tuple[Set[int], AcceleratorConfig]],
    ) -> List[SubgraphCost]:
        """Evaluate a batch of (nodes, acc) queries through the executor.

        Cache hits are served directly; distinct misses are submitted to the
        executor as one batch (where ``process``/``vector`` backends get
        their parallelism) and adopted into the cache on return.  Results
        come back in query order and are identical to issuing
        :meth:`subgraph` serially — batching changes the execution schedule,
        never the values or the distinct-query accounting.
        """
        results: List[Optional[SubgraphCost]] = [None] * len(queries)
        miss_keys: List[Tuple] = []
        miss_queries: List[Tuple[frozenset, AcceleratorConfig]] = []
        miss_pos: Dict[Tuple, List[int]] = {}
        for i, (nodes, acc) in enumerate(queries):
            fs = frozenset(nodes)
            key = self._key(fs, acc)
            self.lookups += 1
            for scope in self._run_scopes:
                scope.add(key)
            hit = self._cache.get(key)
            if hit is not None:
                results[i] = hit
            elif key in miss_pos:
                miss_pos[key].append(i)
            else:
                miss_pos[key] = [i]
                miss_keys.append(key)
                miss_queries.append((fs, acc))
        if miss_queries:
            with obs.span("evaluate_batch", queries=len(queries),
                          misses=len(miss_queries),
                          backend=self.executor.name):
                costs = self.executor.evaluate(self.kernel, miss_queries)
            # every miss counts as one true cost-model invocation, whichever
            # executor computed it — so run_ga/run_sa report the same
            # ``evaluations`` under every backend; ``merged`` stays reserved
            # for cross-evaluator adoption (parallel compare join)
            for key, cost in zip(miss_keys, costs):
                self._cache[key] = cost
                self.evaluations += 1
                for i in miss_pos[key]:
                    results[i] = cost
        return results  # type: ignore[return-value]

    @contextmanager
    def count_run(self) -> Iterator[Set[Tuple]]:
        """Track the *distinct* (subgraph, hardware-point) queries of one run.

        Unlike ``evaluations`` (raw cache misses, which shrink as the cache
        warms), the yielded set has the same size however warm the cache is —
        so a strategy's reported evaluation count is identical whether it runs
        alone, after other strategies on a shared evaluator, or in a cold
        worker process.  Scopes nest: an inner run's queries also count toward
        every enclosing scope.
        """
        touched: Set[Tuple] = set()
        self._run_scopes.append(touched)
        try:
            yield touched
        finally:
            # pop by position, not value: nested scope sets can be *equal*
            # (same keys), and scopes unwind strictly LIFO
            assert self._run_scopes[-1] is touched
            self._run_scopes.pop()

    def merge_cache(self, entries: Mapping[Tuple, SubgraphCost]) -> int:
        """Adopt another evaluator's cache entries (parallel-worker join).

        Existing keys win (the cost model is deterministic, so both sides
        hold equal values anyway).  Returns the number of new entries.
        """
        added = 0
        for key, val in entries.items():
            if key not in self._cache:
                self._cache[key] = val
                added += 1
        self.merged += added
        return added

    def cache_snapshot(self) -> Dict[Tuple, SubgraphCost]:
        """Picklable copy of the memo table, for cross-process merging."""
        return dict(self._cache)

    def merge_structures(
            self, entries: Mapping[Tuple, SubgraphStructure]) -> int:
        """Adopt canonical structure entries from a peer evaluator's kernel
        (the structure half of parallel ``compare``'s merge-on-join; the
        cost half is :meth:`merge_cache`).  Returns new entries adopted."""
        return self.kernel.merge_canon(entries)

    def structure_snapshot(self) -> Dict[Tuple, SubgraphStructure]:
        """Picklable copy of the kernel's canonical structure tier."""
        return self.kernel.canon_snapshot()

    def counters(self) -> Dict[str, Any]:
        """One flat dict of every cache/structure counter (the ``--profile``
        surface).  Structure counters are process-local: misses evaluated by
        a worker backend show up here only as adopted canonical entries
        (``structure_merged``), not as local derivations."""
        k = self.kernel
        out: Dict[str, Any] = {
            "lookups": self.lookups,
            "evaluations": self.evaluations,
            "merged": self.merged,
            "structure_raw_hits": k.structure_raw_hits,
            "structure_canon_hits": k.structure_canon_hits,
            "structure_disk_hits": k.structure_disk_hits,
            "structure_misses": k.structure_misses,
            "structure_merged": k.structure_merged,
            "structure_derive_s": k.structure_time_s,
            "canonical": k.canonical,
        }
        if k.struct_cache is not None:
            out["structure_disk_writes"] = k.struct_cache.writes
        return out

    def plan(self, groups: Sequence[Set[int]], acc: AcceleratorConfig) -> PlanCost:
        return PlanCost(
            subgraphs=[self.subgraph(s, acc) for s in groups], acc=acc
        )

    def plan_batch(
        self,
        items: Sequence[Tuple[Sequence[Set[int]], AcceleratorConfig]],
    ) -> List[PlanCost]:
        """Cost many plans in one executor batch (order preserved)."""
        queries = [(s, acc) for groups, acc in items for s in groups]
        costs = self.evaluate_batch(queries)
        plans: List[PlanCost] = []
        pos = 0
        for groups, acc in items:
            n = len(groups)
            plans.append(PlanCost(subgraphs=costs[pos:pos + n], acc=acc))
            pos += n
        return plans
