"""Baseline partition/DSE methods (paper §4.2).

* greedy        — Halide-style function grouping [47]: start from singletons,
                  repeatedly apply the connected merge with the greatest cost
                  benefit until no merge helps.
* dp            — Irregular-NN [73]: order layers by (depth, id); DP over the
                  sequence where every subgraph must be a contiguous run.
* enumeration   — Fused-CNN/Jangda [4, 25] state-compression DP over downward-
                  closed node sets ("ideals"); exact but exponential, so it is
                  budgeted and reports completion.
* sa            — simulated annealing [33] re-using Cocco's mutation operators.
* two-step      — RS+GA / GS+GA: sample capacities, run partition-only GA per
                  capacity, keep the best (paper §5.1.3).
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass, replace
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from .cost import AcceleratorConfig, CachedEvaluator, PlanCost
from .ga import (
    Genome,
    HWSpace,
    Objective,
    SearchResult,
    evaluate_genomes,
    mutate,
    run_ga,
)
from .graph import Graph
from .partition import (
    groups_of,
    normalize,
    singleton_partition,
    split_to_fit,
)


# ---------------------------------------------------------------------------
# greedy (Halide)
# ---------------------------------------------------------------------------

def greedy_partition(
    g: Graph,
    acc: AcceleratorConfig,
    objective: Objective,
    out_tile: int = 1,
    ev: Optional[CachedEvaluator] = None,
    eval_budget: int = 30_000,
) -> Tuple[List[Set[int]], PlanCost, int]:
    """Returns (groups, plan, evaluations).  ``eval_budget`` bounds the
    quadratic merge search on large irregular graphs (the paper's greedy has
    the same scaling problem — §4.2.2)."""
    ev = ev or CachedEvaluator(g, out_tile=out_tile)
    groups = singleton_partition(g)

    def plan_cost(gr: List[Set[int]]) -> float:
        return objective.cost(ev.plan(gr, acc), acc)

    cur_cost = plan_cost(groups)
    n_eval = 1
    while n_eval < eval_budget:
        gid = {u: i for i, s in enumerate(groups) for u in s}
        pairs = {(min(gid[e.src], gid[e.dst]), max(gid[e.src], gid[e.dst]))
                 for e in g.edges if gid[e.src] != gid[e.dst]}
        best_delta, best_groups = 0.0, None
        for a, b in sorted(pairs):
            cand = [set(s) for s in groups]
            cand[a] |= cand[b]
            del cand[b]
            try:
                cand = normalize(g, cand)
            except RuntimeError:
                continue
            # skip merges made infeasible (greedy cannot stream multi-layer)
            if any(not ev.subgraph(s, acc).feasible for s in cand):
                continue
            c = plan_cost(cand)
            n_eval += 1
            if cur_cost - c > best_delta:
                best_delta, best_groups = cur_cost - c, cand
        if best_groups is None:
            break
        groups, cur_cost = best_groups, cur_cost - best_delta
    return groups, ev.plan(groups, acc), n_eval


# ---------------------------------------------------------------------------
# DP (Irregular-NN): contiguous runs in depth order
# ---------------------------------------------------------------------------

def _depth_order(g: Graph) -> List[int]:
    depth = [0] * g.n
    for v in g.topo_order():
        for e in g.in_edges(v):
            depth[v] = max(depth[v], depth[e.src] + 1)
    return sorted(range(g.n), key=lambda v: (depth[v], v))


def dp_partition(
    g: Graph,
    acc: AcceleratorConfig,
    objective: Objective,
    out_tile: int = 1,
    ev: Optional[CachedEvaluator] = None,
) -> Tuple[List[Set[int]], PlanCost, int]:
    ev = ev or CachedEvaluator(g, out_tile=out_tile)
    # the recurrence sums per-subgraph costs, so decompose by the additive
    # objective (for non-additive metrics: the documented ema surrogate —
    # see Objective.decomposition); the caller scores the plan we return
    # with the true objective
    objective = objective.decomposition()
    order = _depth_order(g)
    n = g.n
    INF = math.inf
    dp = [INF] * (n + 1)
    back = [-1] * (n + 1)
    dp[0] = 0.0
    n_eval = 0
    for i in range(1, n + 1):
        for j in range(i - 1, -1, -1):
            seg = set(order[j:i])
            # subgraphs must be connected; contiguity in depth order is the
            # paper's constraint, connectivity ours (invalid otherwise)
            if len(seg) > 1 and not g.is_connected(seg):
                continue
            c = ev.subgraph(seg, acc)
            n_eval += 1
            if not c.feasible:
                continue
            plan = ev.plan([seg], acc)
            val = dp[j] + objective.cost(plan, acc) - (
                acc.buf_size_total if objective.alpha is not None else 0.0
            )
            if dp[j] + 1e-12 < INF and val < dp[i]:
                dp[i] = val
                back[i] = j
    # reconstruct
    groups: List[Set[int]] = []
    i = n
    while i > 0:
        j = back[i]
        if j < 0:  # fallback: singleton
            groups.append({order[i - 1]})
            i -= 1
        else:
            groups.append(set(order[j:i]))
            i = j
    groups.reverse()
    try:
        groups = normalize(g, groups)
    except RuntimeError:
        groups = singleton_partition(g)
    groups = split_to_fit(g, groups, acc, out_tile=out_tile, ev=ev)
    return groups, ev.plan(groups, acc), n_eval


# ---------------------------------------------------------------------------
# enumeration (state-compression DP over ideals)
# ---------------------------------------------------------------------------

@dataclass
class EnumResult:
    groups: Optional[List[Set[int]]]
    plan: Optional[PlanCost]
    complete: bool
    states: int


def enumerate_partitions(
    g: Graph,
    acc: AcceleratorConfig,
    objective: Objective,
    out_tile: int = 1,
    state_budget: int = 2_000_000,
    ev: Optional[CachedEvaluator] = None,
) -> EnumResult:
    """Exact DP: dp[ideal] = min partition cost of the ideal, transitioning by
    appending one feasible connected subgraph whose union is again an ideal.
    The per-layer cost is additive, so this is optimal (non-additive
    metrics decompose by ``Objective.decomposition()``'s ema surrogate and
    the caller re-scores the plan with the true objective).  Exponential in
    the graph's antichain structure — budgeted."""
    ev = ev or CachedEvaluator(g, out_tile=out_tile)
    objective = objective.decomposition()
    preds = [set(g.preds(v)) for v in range(g.n)]
    succs = [set(g.succs(v)) for v in range(g.n)]
    full = frozenset(range(g.n))
    dp: Dict[FrozenSet[int], float] = {frozenset(): 0.0}
    back: Dict[FrozenSet[int], Tuple[FrozenSet[int], FrozenSet[int]]] = {}
    # process ideals in order of size using a dict-of-size frontier
    by_size: Dict[int, List[FrozenSet[int]]] = {0: [frozenset()]}
    states = 0
    complete = True

    for size in range(g.n):
        for ideal in by_size.get(size, []):
            base = dp[ideal]
            frontier = [v for v in range(g.n)
                        if v not in ideal and preds[v] <= ideal]
            # --- collect: grow connected subgraphs from each frontier node
            # (dedup by set).  The walk never depends on cost results, so it
            # runs to completion before any evaluation — which lets the whole
            # ideal's candidate set go through the engine as one batch.
            seen_subs: Set[FrozenSet[int]] = set()
            subs_in_order: List[FrozenSet[int]] = []
            stack: List[FrozenSet[int]] = [frozenset([v]) for v in frontier]
            while stack:
                sub = stack.pop()
                if sub in seen_subs:
                    continue
                seen_subs.add(sub)
                states += 1
                if states > state_budget:
                    complete = False
                    stack.clear()
                    break
                subs_in_order.append(sub)
                # extensions: nodes adjacent to sub, addable (preds satisfied)
                for u in sorted(sub):
                    for w in sorted(succs[u] | preds[u]):
                        if w in ideal or w in sub:
                            continue
                        if preds[w] <= (ideal | sub):
                            ext = frozenset(sub | {w})
                            if ext not in seen_subs:
                                stack.append(ext)
            # --- submit + apply: DP transitions in walk order
            costs = ev.evaluate_batch([(set(sub), acc)
                                       for sub in subs_in_order])
            for sub, c in zip(subs_in_order, costs):
                if not c.feasible:
                    continue
                plan = ev.plan([set(sub)], acc)
                cost = objective.cost(plan, acc) - (
                    acc.buf_size_total if objective.alpha is not None else 0.0
                )
                nxt = frozenset(ideal | sub)
                val = base + cost
                if val < dp.get(nxt, math.inf):
                    dp[nxt] = val
                    back[nxt] = (ideal, sub)
                    by_size.setdefault(len(nxt), []).append(nxt)
            if not complete:
                break
        if not complete:
            break

    if full not in dp:
        return EnumResult(None, None, complete=False, states=states)
    groups: List[Set[int]] = []
    cur = full
    while cur:
        prev, sub = back[cur]
        groups.append(set(sub))
        cur = prev
    groups.reverse()
    return EnumResult(groups, ev.plan(groups, acc), complete, states)


# ---------------------------------------------------------------------------
# simulated annealing
# ---------------------------------------------------------------------------

def run_sa(
    g: Graph,
    objective: Objective,
    hw: HWSpace,
    sample_budget: int = 50_000,
    t0: float = 1.0,
    t_end: float = 1e-3,
    seed: int = 0,
    out_tile: int = 1,
    ev: Optional[CachedEvaluator] = None,
) -> SearchResult:
    """SA with Cocco's mutation operators as the neighbourhood (§4.2.4).

    Each step's pending genome goes through the same collect-then-submit
    evaluation path as a GA generation (:func:`~repro_torch.core.ga.evaluate_genomes`
    with a batch of one), so SA shares the engine's repair/costing code
    instead of a private evaluation loop.
    """
    rng = random.Random(seed)
    ev = ev or CachedEvaluator(g, out_tile=out_tile)

    def evaluate(ind: Genome) -> None:
        evaluate_genomes(g, [ind], objective, ev)

    from .partition import random_partition

    cur = Genome(random_partition(g, rng), hw.sample(rng))
    evaluate(cur)
    best = cur.clone()
    best.cost, best.plan = cur.cost, cur.plan
    history = [(1, best.cost)]
    samples = 1
    # relative temperature: scale by initial cost magnitude
    scale = max(abs(cur.cost), 1e-9)
    while samples < sample_budget:
        frac = samples / sample_budget
        temp = scale * t0 * (t_end / t0) ** frac
        cand = mutate(g, cur, hw, rng)
        evaluate(cand)
        samples += 1
        d = cand.cost - cur.cost
        if d <= 0 or rng.random() < math.exp(-d / max(temp, 1e-12)):
            cur = cand
        if cand.cost < best.cost:
            best = cand.clone()
            best.cost, best.plan = cand.cost, cand.plan
        history.append((samples, best.cost))
    return SearchResult(best=best, history=history, population_log=[],
                        samples=samples, evaluations=ev.evaluations)


# ---------------------------------------------------------------------------
# two-step schemes (RS+GA / GS+GA)
# ---------------------------------------------------------------------------

def run_two_step(
    g: Graph,
    objective: Objective,
    hw: HWSpace,
    sampler: str = "random",          # "random" | "grid"
    capacity_samples: int = 10,
    samples_per_capacity: int = 5_000,
    seed: int = 0,
    out_tile: int = 1,
    ev: Optional[CachedEvaluator] = None,
) -> SearchResult:
    """Decoupled capacity search then partition-only GA per capacity.

    ``ev`` shares one :class:`CachedEvaluator` across the per-capacity GA
    runs (cache keys include the hardware point, so entries never collide);
    the returned ``evaluations`` is the number of cache misses this call
    incurred, whichever evaluator was used.
    """
    rng = random.Random(seed)
    ev = ev or CachedEvaluator(g, out_tile=out_tile)
    ev_start = ev.evaluations
    if hw.mode == "fixed":
        # degenerate: the single capacity is the base point itself
        picks = [(hw.base.glb_bytes, hw.base.wbuf_bytes)]
    else:
        if hw.mode == "separate":
            cands = [(gl, wb) for gl in hw.glb_candidates
                     for wb in hw.wbuf_candidates]
        else:
            cands = [(sh, 0) for sh in hw.shared_candidates]
        if sampler == "random":
            picks = [cands[rng.randrange(len(cands))]
                     for _ in range(capacity_samples)]
        else:  # grid: coarse, large-to-small (paper §5.3.2)
            step = max(1, len(cands) // capacity_samples)
            picks = list(reversed(cands))[::step][:capacity_samples]

    best: Optional[Genome] = None
    history: List[Tuple[int, float]] = []
    samples = 0
    running = math.inf
    for (glb, wb) in picks:
        shared = hw.base.shared if hw.mode == "fixed" else hw.mode == "shared"
        acc = replace(hw.base, glb_bytes=glb, wbuf_bytes=wb, shared=shared)
        res = run_ga(
            g, objective, HWSpace(mode="fixed", base=acc),
            sample_budget=samples_per_capacity,
            population=min(100, max(10, samples_per_capacity // 5)),
            seed=rng.randrange(1 << 30), out_tile=out_tile,
            ev=ev,
        )
        for (_, c) in res.history:
            samples += 1
            running = min(running, c)
            history.append((samples, running))
        if best is None or res.best.cost < best.cost:
            best = res.best
    return SearchResult(best=best, history=history, population_log=[],
                        samples=samples,
                        evaluations=ev.evaluations - ev_start)
