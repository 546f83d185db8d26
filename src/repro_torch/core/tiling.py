"""Consumption-centric subgraph execution scheme (paper §3.1, Fig. 5).

Given a subgraph (a set of nodes of a :class:`~repro_torch.core.graph.Graph` plus the
external tensors feeding it), derive for every tensor resident in the global
buffer:

* ``delta``  -- the update offset Delta: rows of new data produced per update,
* ``x``      -- the buffer allocation in rows (the paper's ``x``),
* ``upd_num``-- updates per subgraph-level elementary operation (stage 3),

using the three-stage flow:

  stage 1:  output nodes of the subgraph get a chosen tile size (``out_tile``
            rows; smaller tiles hold larger subgraphs, paper §3.1),
  stage 2:  reverse topological order; ``Delta(u) = lcm_v{ Delta(v) * s(v) }``
            over sliding consumers v, and
            ``x(u) = max_v f_v(Delta(u) / s(v))`` with
            ``f_v(k) = F(v) + (k-1) * s(v)``,
  stage 3:  per-edge steady-state balance ``rate(u) * Delta(u) =
            rate(v) * Delta(v) * s(v)`` solved exactly over the rationals and
            scaled to the minimal co-prime integer solution (the paper's unique
            co-prime ``upd_num`` vector).

``full`` edges (attention/FC-over-sequence/global pooling) force the producer's
entire tensor to be buffered and split the pipeline into phases; the rate system
is solved per sliding-connected component.

External inputs of the subgraph are modelled as virtual nodes (the paper's
negative-numbered nodes): they stream rows from DRAM and are buffered like any
other tensor.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from fractions import Fraction
from typing import Dict, List, Optional, Set, Tuple

from .graph import FULL, SLIDING, Edge, Graph


@dataclass
class TensorSchedule:
    """Execution-scheme result for one resident tensor (node output)."""

    node: int                 # graph node index (producer of this tensor)
    delta: int                # update offset in rows
    x: int                    # allocated rows in the buffer
    upd_num: int              # updates per elementary operation
    external: bool            # True if produced outside the subgraph (DRAM load)
    full_resident: bool = False  # buffered in entirety (full-edge consumer)

    def alloc_rows(self) -> int:
        return self.x


@dataclass
class SubgraphSchedule:
    """Full execution scheme of one subgraph."""

    nodes: List[int]                       # internal nodes, topological order
    tensors: Dict[int, TensorSchedule]     # keyed by producer node idx
    n_elementary_ops: int                  # ops per full sweep
    phases: int                            # 1 + number of full-edge cuts

    def footprint_rows(self, node: int) -> int:
        return self.tensors[node].x


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)


def derive_schedule(
    g: Graph,
    nodes: Set[int],
    out_tile: int = 1,
) -> SubgraphSchedule:
    """Derive the consumption-centric execution scheme for ``nodes``.

    Tensors considered: outputs of every internal node, plus every external
    producer feeding the subgraph (virtual input nodes).
    """
    if not nodes:
        raise ValueError("empty subgraph")
    internal = sorted(nodes)
    ext_producers = sorted({e.src for e in g.boundary_in(nodes)})
    all_tensors = internal + [p for p in ext_producers if p not in nodes]

    # Consumers *inside* the subgraph of each tensor.
    cons: Dict[int, List[Edge]] = {t: [] for t in all_tensors}
    for e in g.edges:
        if e.dst in nodes and e.src in cons:
            cons[e.src].append(e)

    delta: Dict[int, int] = {}
    x: Dict[int, int] = {}
    full_res: Dict[int, bool] = {}

    # Stage 1 + 2: reverse topological order over tensors (graph indices are
    # topological; external producers always precede their consumers).
    for t in sorted(all_tensors, reverse=True):
        out_len = g.nodes[t].out_len
        sliding_cons = [e for e in cons[t] if e.kind == SLIDING]
        full_cons = [e for e in cons[t] if e.kind == FULL]
        is_subgraph_output = t in nodes and not cons[t]

        if is_subgraph_output:
            # Stage 1: output nodes drive the execution with the chosen tile.
            delta[t] = min(out_tile, out_len)
            x[t] = delta[t]
            full_res[t] = False
            continue

        if sliding_cons:
            d = 1
            for e in sliding_cons:
                d = _lcm(d, delta[e.dst] * e.s)
            d = min(d, out_len)
            req = 0
            for e in sliding_cons:
                k = max(1, d // e.s)
                # paper's f_v(k) = F + (k-1)s with k = delta(u)/s(v), i.e.
                # x = F + delta - s.  Exact for delta-quantum production with
                # prologue phase alignment (head starts at x, then +delta) and
                # row-granular consumption; steady-state peak occupancy is
                # max_a [F + a] over consumer offsets a = j*s mod delta,
                # a_max = delta - s.  Verified mechanically by core/simulate.py.
                req = max(req, e.window(k))
            xx = min(req, out_len)
        else:
            d, xx = out_len, out_len  # only full consumers: produce everything
        if full_cons:
            xx = out_len  # entire tensor must become resident
        delta[t] = d
        x[t] = xx
        full_res[t] = bool(full_cons) or (xx >= out_len and bool(full_cons))

    # Stage 3: minimal co-prime integer rates.  Solve per weakly-connected
    # component of the *sliding* dependency structure among all tensors.
    upd: Dict[int, int] = {t: 1 for t in all_tensors}
    adj: Dict[int, List[Tuple[int, Edge, bool]]] = {t: [] for t in all_tensors}
    for t in all_tensors:
        for e in cons[t]:
            if e.kind != SLIDING:
                continue
            adj[t].append((e.dst, e, True))    # producer -> consumer
            adj[e.dst].append((t, e, False))   # consumer -> producer

    seen: Set[int] = set()
    for root in all_tensors:
        if root in seen:
            continue
        comp: List[int] = []
        rate: Dict[int, Fraction] = {root: Fraction(1)}
        stack = [root]
        seen.add(root)
        while stack:
            u = stack.pop()
            comp.append(u)
            for (v, e, forward) in adj[u]:
                # balance: rate(src) * delta(src) == rate(dst) * delta(dst) * s
                if forward:  # u = src, v = dst
                    r = rate[u] * delta[u] / (delta[v] * e.s)
                else:        # u = dst, v = src
                    r = rate[u] * delta[u] * e.s / delta[v]
                if v in rate:
                    if rate[v] != r:
                        raise ValueError(
                            f"inconsistent stride structure at node {v}: "
                            f"{rate[v]} vs {r} (parallel paths with mismatched "
                            f"total stride)"
                        )
                else:
                    rate[v] = r
                    seen.add(v)
                    stack.append(v)
        # scale component rates to minimal co-prime integers
        denom_lcm = 1
        for r in rate.values():
            denom_lcm = _lcm(denom_lcm, r.denominator)
        ints = {t: int(r * denom_lcm) for t, r in rate.items()}
        gg = 0
        for val in ints.values():
            gg = math.gcd(gg, val)
        for t in comp:
            upd[t] = ints[t] // gg if gg else 1

    # Elementary operations per sweep: driven by the subgraph's sink tensor(s).
    sinks = [t for t in internal if not cons[t]]
    n_ops = 1
    for t in sinks:
        per_op = upd[t] * delta[t]
        n_ops = max(n_ops, math.ceil(g.nodes[t].out_len / per_op))

    # Count phases: each tensor consumed through a full edge ends a phase.
    n_full = sum(1 for t in all_tensors
                 if any(e.kind == FULL for e in cons[t]))
    tensors = {
        t: TensorSchedule(
            node=t,
            delta=delta[t],
            x=x[t],
            upd_num=upd[t],
            external=t not in nodes,
            full_resident=x[t] >= g.nodes[t].out_len
            and any(e.kind == FULL for e in cons[t]),
        )
        for t in all_tensors
    }
    return SubgraphSchedule(
        nodes=internal, tensors=tensors, n_elementary_ops=n_ops,
        phases=1 + n_full,
    )


def production_centric_footprint(
    g: Graph, nodes: Set[int], in_tile: int = 1
) -> Dict[int, int]:
    """The strawman of Fig. 4(a): forward-derive tile sizes from a fixed input
    tile; producers emit everything derivable, consumers lag behind the
    smallest branch, so extra rows pile up.  Returns rows resident per tensor —
    used in tests/benchmarks to show the consumption-centric scheme needs
    less memory (paper Fig. 4)."""
    internal = sorted(nodes)
    ext = sorted({e.src for e in g.boundary_in(nodes)})
    produced: Dict[int, int] = {}  # rows produced per elementary op
    for t in ext:
        produced[t] = max(in_tile, 1)
    resident: Dict[int, int] = {t: produced[t] for t in ext}
    for t in internal:
        ins = [e for e in g.in_edges(t)]
        if not ins:
            produced[t] = in_tile
            resident[t] = in_tile
            continue
        k = None
        for e in ins:
            if e.kind == FULL:
                k = 0
                break
            avail = produced.get(e.src, 0)
            kk = max(0, (avail - e.F) // e.s + 1)
            k = kk if k is None else min(k, kk)
        produced[t] = max(0, k or 0)
        resident[t] = max(produced[t], 1)
    # rows that can actually be consumed downstream this op
    consumed: Dict[int, int] = {}
    for t in reversed(internal + ext):
        outs = [e for e in g.out_edges(t) if e.dst in nodes]
        if not outs:
            consumed[t] = produced.get(t, 0)
            continue
        need = 0
        for e in outs:
            if e.kind == FULL:
                need = g.nodes[t].out_len
                break
            need = max(need, e.F + (max(produced.get(e.dst, 0), 1) - 1) * e.s)
        consumed[t] = min(need, produced.get(t, 0))
    # surplus rows (produced but not consumable) are the extra memory
    return {
        t: resident[t] + max(0, produced.get(t, 0) - consumed.get(t, 0))
        for t in resident
    }
