"""Reference executor for the consumption-centric scheme (validation only).

Executes a subgraph row-by-row with *actual data*, under hard per-tensor buffer
capacities equal to the derived allocations ``x``, and checks the paper's
claims mechanically:

* correctness  — every produced row equals the whole-tensor reference value,
* full reuse   — every external row is loaded from "DRAM" exactly once and no
                 intermediate row is ever recomputed,
* sufficiency  — with only ``x`` rows of buffer per tensor the schedule
                 completes without deadlock (tightness can be probed by
                 shrinking an allocation and expecting deadlock).

Nodes compute ``y[i] = tanh(b + sum_e dot(w_e, src_e[i*s : i*s+F]))`` over
their sliding in-edges (full edges contribute a whole-tensor reduction), which
makes row misindexing observable in the values.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from .graph import FULL, SLIDING, Graph
from .tiling import SubgraphSchedule, derive_schedule


class DeadlockError(AssertionError):
    pass


@dataclass
class SimResult:
    max_occupancy: Dict[int, int]         # rows resident, max over time
    dram_loads: Dict[int, int]            # rows loaded per external tensor
    rounds: int
    updates: Dict[int, int]               # update count per internal node


class _Buffer:
    """Row buffer with a hard capacity and liveness-based eviction."""

    def __init__(self, capacity: int) -> None:
        self.capacity = capacity
        self.rows: Dict[int, float] = {}
        self.max_occ = 0
        self.head = 0  # next row index to produce / load

    def has_space(self) -> bool:
        return len(self.rows) < self.capacity

    def put(self, idx: int, val: float) -> None:
        if len(self.rows) >= self.capacity:
            raise DeadlockError(f"buffer overflow at capacity {self.capacity}")
        self.rows[idx] = val
        self.max_occ = max(self.max_occ, len(self.rows))

    def window(self, lo: int, hi: int) -> Optional[np.ndarray]:
        try:
            return np.array([self.rows[i] for i in range(lo, hi)])
        except KeyError:
            return None

    def evict_below(self, idx: int) -> None:
        for r in [r for r in self.rows if r < idx]:
            del self.rows[r]


def reference_forward(
    g: Graph, nodes: Set[int], rng: np.random.Generator
) -> Tuple[Dict[int, np.ndarray], Dict[Tuple[int, int], np.ndarray], Dict[int, float]]:
    """Whole-tensor reference; external inputs get random data."""
    ext = sorted({e.src for e in g.boundary_in(nodes)})
    vals: Dict[int, np.ndarray] = {}
    for t in ext:
        vals[t] = rng.normal(size=g.nodes[t].out_len)
    kernels: Dict[Tuple[int, int], np.ndarray] = {}
    bias: Dict[int, float] = {}
    for v in sorted(nodes):
        bias[v] = float(rng.normal())
        acc = np.full(g.nodes[v].out_len, bias[v])
        for e in g.in_edges(v):
            w = rng.normal(size=(e.F if e.kind == SLIDING else
                                 g.nodes[e.src].out_len))
            kernels[(e.src, v)] = w
            src = vals[e.src]
            if e.kind == FULL:
                acc = acc + float(np.dot(w, src))
            else:
                need = e.F + (g.nodes[v].out_len - 1) * e.s
                if need > len(src):
                    raise ValueError(
                        f"node {v}: out_len inconsistent with edge "
                        f"({e.src}->{v}, F={e.F}, s={e.s})"
                    )
                for i in range(g.nodes[v].out_len):
                    acc[i] += float(np.dot(w, src[i * e.s: i * e.s + e.F]))
        vals[v] = np.tanh(acc)
    return vals, kernels, bias


def simulate_subgraph(
    g: Graph,
    nodes: Set[int],
    schedule: Optional[SubgraphSchedule] = None,
    out_tile: int = 1,
    seed: int = 0,
    capacity_override: Optional[Dict[int, int]] = None,
    max_stall_rounds: int = 4,
) -> SimResult:
    """Run the capacity-constrained tiled execution; assert correctness."""
    sched = schedule or derive_schedule(g, nodes, out_tile=out_tile)
    rng = np.random.default_rng(seed)
    ref_vals, kernels, bias = reference_forward(g, nodes, rng)

    internal = sorted(nodes)
    ext = sorted({e.src for e in g.boundary_in(nodes)})
    cap = {t: sched.tensors[t].x for t in internal + ext}
    if capacity_override:
        cap.update(capacity_override)
    bufs: Dict[int, _Buffer] = {t: _Buffer(cap[t]) for t in internal + ext}
    loads: Dict[int, int] = {t: 0 for t in ext}
    loaded_once: Dict[int, Set[int]] = {t: set() for t in ext}
    produced_cnt: Dict[int, int] = {t: 0 for t in internal}
    updates: Dict[int, int] = {t: 0 for t in internal}
    recomputed = 0

    cons: Dict[int, List] = {t: [] for t in internal + ext}
    for e in g.edges:
        if e.dst in nodes and e.src in cons:
            cons[e.src].append(e)

    def consumer_low_water(tensor: int) -> int:
        """Smallest still-needed row index across internal consumers."""
        lo = None
        for e in cons[tensor]:
            nxt = bufs[e.dst].head
            if e.kind == FULL:
                need = 0 if nxt < g.nodes[e.dst].out_len else 10**18
            else:
                need = nxt * e.s
            lo = need if lo is None else min(lo, need)
        return 10**18 if lo is None else lo  # no consumer: immediate writeback

    def evict_all() -> None:
        for t in internal + ext:
            bufs[t].evict_below(consumer_low_water(t))

    def try_load_external(t: int, hi: int) -> bool:
        """Stream external rows up to (exclusive) ``hi``, evicting dead rows
        eagerly; returns False if capacity blocks the load."""
        b = bufs[t]
        hi = min(hi, g.nodes[t].out_len)
        while b.head < hi:
            if not b.has_space():
                b.evict_below(consumer_low_water(t))
                if not b.has_space():
                    return False
            r = b.head
            assert r not in loaded_once[t], f"external row {t}:{r} loaded twice"
            loaded_once[t].add(r)
            b.put(r, float(ref_vals[t][r]))
            loads[t] += 1
            b.head += 1
        return True

    def produce_one_update(v: int) -> int:
        """One update of node v: up to delta(v) rows, row-granular with eager
        eviction (consumers may lag producers within their x allocations; the
        delta phase alignment comes from the prologue, see tiling.py).
        Returns rows made (0 = stall)."""
        nonlocal recomputed
        b = bufs[v]
        out_len = g.nodes[v].out_len
        made = 0
        budget = min(sched.tensors[v].delta, out_len - b.head)
        while made < budget:
            i = b.head
            acc = bias[v]
            ok = True
            for e in g.in_edges(v):
                if e.kind == FULL:
                    lo, hi = 0, g.nodes[e.src].out_len
                else:
                    lo, hi = i * e.s, i * e.s + e.F
                if e.src in loads and not try_load_external(e.src, hi):
                    ok = False
                    break
                if bufs[e.src].window(lo, hi) is None:
                    ok = False
                    break
            if not ok:
                break
            if not b.has_space():
                b.evict_below(consumer_low_water(v))
                if not b.has_space():
                    break
            for e in g.in_edges(v):
                if e.kind == FULL:
                    lo, hi = 0, g.nodes[e.src].out_len
                else:
                    lo, hi = i * e.s, i * e.s + e.F
                seg = bufs[e.src].window(lo, hi)
                acc += float(np.dot(kernels[(e.src, v)], seg))
            val = float(np.tanh(acc))
            assert abs(val - ref_vals[v][i]) < 1e-9, (
                f"node {v} row {i}: {val} != ref {ref_vals[v][i]}"
            )
            b.put(i, val)
            b.head += 1
            made += 1
        if made:
            updates[v] += 1
            produced_cnt[v] += made
        return made

    total_target = sum(g.nodes[v].out_len for v in internal)
    rounds = 0
    stalls = 0
    while sum(produced_cnt.values()) < total_target:
        rounds += 1
        progress = 0
        for v in internal:
            progress += produce_one_update(v)
            evict_all()
        if progress == 0:
            stalls += 1
            if stalls >= max_stall_rounds:
                raise DeadlockError(
                    f"no progress after {rounds} rounds "
                    f"(produced {sum(produced_cnt.values())}/{total_target})"
                )
        else:
            stalls = 0

    assert recomputed == 0
    for v in internal:
        assert produced_cnt[v] == g.nodes[v].out_len
    for t, b in bufs.items():
        assert b.max_occ <= cap[t]
    return SimResult(
        max_occupancy={t: b.max_occ for t, b in bufs.items()},
        dram_loads=loads,
        rounds=rounds,
        updates=updates,
    )
