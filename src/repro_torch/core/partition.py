"""Graph-level partition schemes (paper §4.1.1).

A partition ``P : V -> N`` assigns each layer to a subgraph; validity requires
``P(u) <= P(v)`` for every edge (computed before use) and every subgraph to be
weakly connected.  Subgraphs execute in id order.

``normalize`` repairs an arbitrary grouping into a valid scheme (used after GA
crossover/mutations): split disconnected groups, break quotient-graph cycles by
topological bisection, then renumber groups in quotient-topological order.
``split_to_fit`` is the paper's in-situ tuning (§4.4.4): oversized subgraphs
are split during evaluation instead of discarding the genome.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.obs import recorder as obs

from .cost import AcceleratorConfig, PlanCost, evaluate_partition, evaluate_subgraph
from .graph import Graph


Partition = List[int]  # P[node] = subgraph id


def groups_of(P: Sequence[int]) -> List[Set[int]]:
    """Group node sets ordered by subgraph id."""
    byid: Dict[int, Set[int]] = {}
    for v, pid in enumerate(P):
        byid.setdefault(pid, set()).add(v)
    return [byid[k] for k in sorted(byid)]


def partition_of(groups: Sequence[Set[int]], n: int) -> Partition:
    P = [0] * n
    for i, s in enumerate(groups):
        for v in s:
            P[v] = i
    return P


def is_valid(g: Graph, P: Sequence[int]) -> bool:
    for e in g.edges:
        if P[e.src] > P[e.dst]:
            return False
    for s in groups_of(P):
        if not g.is_connected(s):
            return False
    return True


def _quotient_edges(g: Graph, gid: Sequence[int]) -> Set[Tuple[int, int]]:
    q = set()
    for e in g.edges:
        a, b = gid[e.src], gid[e.dst]
        if a < 0 or b < 0:
            raise ValueError(
                f"groups do not cover node {e.src if a < 0 else e.dst}")
        if a != b:
            q.add((a, b))
    return q


def _topo_order_quotient(n_groups: int,
                         qedges: Set[Tuple[int, int]]) -> Optional[List[int]]:
    """Kahn, smallest id first (a min-heap pops the same order the previous
    sort-per-iteration implementation did); None if cyclic."""
    import heapq

    indeg = [0] * n_groups
    out: Dict[int, List[int]] = {i: [] for i in range(n_groups)}
    for a, b in qedges:
        out[a].append(b)
        indeg[b] += 1
    heap = [i for i in range(n_groups) if indeg[i] == 0]
    heapq.heapify(heap)
    order = []
    while heap:
        v = heapq.heappop(heap)
        order.append(v)
        for w in out[v]:
            indeg[w] -= 1
            if indeg[w] == 0:
                heapq.heappush(heap, w)
    return order if len(order) == n_groups else None


def normalize(g: Graph, raw_groups: Sequence[Set[int]]) -> List[Set[int]]:
    """Repair arbitrary groups into a valid ordered partition."""
    # 1. split disconnected groups into weak components (singletons are
    # trivially connected — GA offspring are mostly singletons, so skip
    # the component scan for them)
    groups: List[Set[int]] = []
    for s in raw_groups:
        if not s:
            continue
        if len(s) == 1:
            groups.append(set(s))
        else:
            groups.extend(g.weakly_connected_components(set(s)))

    # 2. break quotient cycles by topological bisection of offending groups
    for _ in range(g.n + 1):
        gid_arr = [-1] * g.n  # -1 = uncovered; _quotient_edges raises on it
        for i, s in enumerate(groups):
            for v in s:
                gid_arr[v] = i
        qedges = _quotient_edges(g, gid_arr)
        order = _topo_order_quotient(len(groups), qedges)
        if order is not None:
            # renumber groups in quotient topological order
            return [groups[i] for i in order]
        # find a group on a cycle: any group with both in- and out-quotient
        # edges to a common strongly-connected region; heuristic: split the
        # largest multi-node group by node-index median
        cand = max((s for s in groups if len(s) > 1), key=len, default=None)
        if cand is None:
            raise RuntimeError("cyclic quotient with singleton groups")
        med = sorted(cand)[len(cand) // 2]
        lo = {v for v in cand if v < med}
        hi = {v for v in cand if v >= med}
        groups.remove(cand)
        for part in (lo, hi):
            if not part:
                continue
            if len(part) == 1:
                groups.append(part)
            else:
                groups.extend(g.weakly_connected_components(part))
    raise RuntimeError("normalize did not converge")


def split_group_topo(g: Graph, s: Set[int], pieces: int = 2) -> List[Set[int]]:
    """Split a group into ~equal topological slices (each then re-split into
    weak components)."""
    order = sorted(s)
    k = max(1, len(order) // pieces)
    out: List[Set[int]] = []
    for i in range(0, len(order), k):
        chunk = set(order[i: i + k])
        if len(chunk) == 1:
            out.append(chunk)
        else:
            out.extend(g.weakly_connected_components(chunk))
    return out


def split_to_fit(
    g: Graph,
    groups: List[Set[int]],
    acc: AcceleratorConfig,
    out_tile: int = 1,
    max_rounds: int = 64,
    ev: Optional["CachedEvaluator"] = None,
) -> List[Set[int]]:
    """In-situ tuning (paper §4.4.4): bisect any infeasible subgraph until all
    fit the buffers (singletons stream, always feasible)."""
    from .cost import CachedEvaluator  # local import to avoid cycle at module load

    ev = ev or CachedEvaluator(g, out_tile=out_tile)
    return split_to_fit_batch(g, [(groups, acc)], ev, max_rounds=max_rounds)[0]


def split_to_fit_batch(
    g: Graph,
    items: Sequence[Tuple[List[Set[int]], AcceleratorConfig]],
    ev: "CachedEvaluator",
    max_rounds: int = 64,
) -> List[List[Set[int]]]:
    """Batched in-situ tuning: repair many plans against one evaluator batch
    per round.

    Round ``k`` collects every still-unrepaired plan's multi-node subgraphs
    into one feasibility batch (where the engine's executor parallelism
    applies), then applies the split decisions — the same decisions, in the
    same order, as running :func:`split_to_fit` per item, since feasibility
    of one subgraph never depends on the others.
    """
    out: List[Optional[List[Set[int]]]] = [None] * len(items)
    groups_of_item: List[List[Set[int]]] = [list(gr) for gr, _ in items]
    active = list(range(len(items)))
    for _ in range(max_rounds):
        if not active:
            break
        obs.add("repair.rounds")
        queries = [(s, items[i][1]) for i in active
                   for s in groups_of_item[i] if len(s) > 1]
        costs = ev.evaluate_batch(queries)
        pos = 0
        n_splits = 0
        still_active: List[int] = []
        for i in active:
            changed = False
            new: List[Set[int]] = []
            for s in groups_of_item[i]:
                if len(s) == 1:
                    new.append(s)
                    continue
                c = costs[pos]
                pos += 1
                if c.feasible:
                    new.append(s)
                else:
                    new.extend(split_group_topo(g, s, pieces=2))
                    changed = True
                    n_splits += 1
            groups_of_item[i] = new
            if changed:
                still_active.append(i)
            else:
                out[i] = normalize(g, new)
        if n_splits:
            obs.add("repair.splits", n_splits)
        active = still_active
    for i in active:  # max_rounds exhausted: fall back to singletons
        out[i] = normalize(g, [{v} for s in groups_of_item[i] for v in s])
    return out  # type: ignore[return-value]


def singleton_partition(g: Graph) -> List[Set[int]]:
    return [{v} for v in range(g.n)]


def random_partition(g: Graph, rng: random.Random,
                     mean_size: float = 3.0) -> List[Set[int]]:
    """Random valid partition: walk nodes in topological order; each node joins
    a random open predecessor group or starts a new one (paper §4.4.1)."""
    gid: Dict[int, int] = {}
    groups: List[Set[int]] = []
    p_join = 1.0 - 1.0 / max(mean_size, 1.0)
    for v in g.topo_order():
        cands = {gid[u] for u in g.preds(v) if u in gid}
        if cands and rng.random() < p_join:
            c = rng.choice(sorted(cands))
            groups[c].add(v)
            gid[v] = c
        else:
            gid[v] = len(groups)
            groups.append({v})
    return normalize(g, groups)


def evaluate_groups(
    g: Graph,
    groups: List[Set[int]],
    acc: AcceleratorConfig,
    out_tile: int = 1,
    repair: bool = True,
    ev: Optional["CachedEvaluator"] = None,
) -> Tuple[List[Set[int]], PlanCost]:
    """Evaluate (optionally repairing in-situ); returns (repaired groups, cost)."""
    from .cost import CachedEvaluator

    ev = ev or CachedEvaluator(g, out_tile=out_tile)
    if repair:
        groups = split_to_fit(g, groups, acc, out_tile=out_tile, ev=ev)
    plan = ev.plan(groups, acc)
    return groups, plan
