"""Genetic co-exploration engine (paper §4.3–4.4, Fig. 9–10).

Genome = (partition scheme, memory configuration).  Operators:

* crossover (Fig. 9b): walk layers in topological order; each undecided layer
  picks a random parent and reproduces that parent's whole subgraph; already-
  decided members are either split out (Child-1) or merged into one of their
  subgraphs (Child-2) — chosen at random.  HW genes average-then-snap.
* mutations (Fig. 9c-e + DSE): modify-node, split-subgraph, merge-subgraph,
  mutation-DSE (normal perturbation snapped to the candidate grid).
* evaluation with in-situ split repair (§4.4.4) written back Lamarckian-style,
* tournament selection (§4.4.5) with elitism.

Fitness = -(cost); cost is Formula 1 (partition-only) or Formula 2
(``BUF_SIZE + alpha * sum_i Cost_M(subgraph_i)``).
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from .cost import (
    GLB_CANDIDATES,
    METRICS,
    SHARED_CANDIDATES,
    WBUF_CANDIDATES,
    AcceleratorConfig,
    CachedEvaluator,
    PlanCost,
)
from repro_torch.obs import recorder as obs

from .graph import Graph
from .partition import (
    groups_of,
    normalize,
    random_partition,
    singleton_partition,
    split_group_topo,
    split_to_fit_batch,
)


# ---------------------------------------------------------------------------
# objective
# ---------------------------------------------------------------------------

# metrics that are additive over subgraphs: plan.metric(m) equals the sum
# of single-subgraph contributions, which is what the additive recurrences
# of the dp/enum baselines require.  "bandwidth" (a time-weighted
# percentile) and the NoC profile metrics ("noc_p95"/"noc_link_peak") are
# not additive — see Objective.decomposition().
ADDITIVE_METRICS: Tuple[str, ...] = ("ema", "energy", "latency")


@dataclass(frozen=True)
class Objective:
    """What the search minimizes."""

    metric: str = "energy"          # one of cost.METRICS
    alpha: Optional[float] = None   # None => Formula 1 (partition-only)

    def __post_init__(self) -> None:
        # fail typos at construction (and hence at ExploreSpec construction),
        # not thousands of samples into a search
        if self.metric not in METRICS:
            raise ValueError(
                f"unknown objective metric {self.metric!r}; valid metrics: "
                f"{', '.join(METRICS)}")

    @property
    def is_additive(self) -> bool:
        return self.metric in ADDITIVE_METRICS

    def decomposition(self) -> "Objective":
        """The objective the additive-DP baselines (dp/enum) decompose by.

        Their recurrences sum per-subgraph costs, which is exact only for
        additive metrics.  For the non-additive profile percentiles
        (``bandwidth``, ``noc_p95``, ``noc_link_peak``) they decompose by
        the additive ``ema`` surrogate — the byte count the bandwidth/NoC
        requirements derive from — and the caller scores the returned plan
        with the *true* objective (so ``ExploreResult.cost`` is always the
        real metric, never the surrogate).  Whole-plan strategies
        (ga/sa/greedy/two_step) optimize every metric directly.
        """
        if self.is_additive:
            return self
        return replace(self, metric="ema")

    def cost(self, plan: PlanCost, acc: AcceleratorConfig) -> float:
        m = plan.metric(self.metric)
        if self.alpha is None:
            return m
        return acc.buf_size_total + self.alpha * m


@dataclass(frozen=True)
class HWSpace:
    """Memory design space (paper §5.3.1).

    ``core_candidates`` adds an optional third genome axis (§5.4.2): the
    multi-core weight-sharing degree.  When non-empty, ``sample``/``blend``/
    ``mutate`` co-explore the core count (applied to both
    ``weight_share_cores`` and ``n_cores``) jointly with the buffer split
    and the partition; when empty (the default) the core count is pinned to
    ``base`` and no rng draw is spent on it, so pre-existing seeded searches
    are bitwise-unchanged.
    """

    mode: str = "fixed"             # "fixed" | "separate" | "shared"
    base: AcceleratorConfig = field(default_factory=AcceleratorConfig)
    glb_candidates: Tuple[int, ...] = tuple(GLB_CANDIDATES)
    wbuf_candidates: Tuple[int, ...] = tuple(WBUF_CANDIDATES)
    shared_candidates: Tuple[int, ...] = tuple(SHARED_CANDIDATES)
    core_candidates: Tuple[int, ...] = ()

    def __post_init__(self) -> None:
        if any(n < 1 for n in self.core_candidates):
            raise ValueError(
                f"core_candidates must all be >= 1, got "
                f"{self.core_candidates}")

    def _with_cores(self, acc: AcceleratorConfig,
                    n: int) -> AcceleratorConfig:
        if (acc.weight_share_cores, acc.n_cores) == (n, n):
            return acc
        return replace(acc, weight_share_cores=n, n_cores=n)

    def sample(self, rng: random.Random) -> AcceleratorConfig:
        if self.mode == "fixed":
            acc = self.base
        elif self.mode == "separate":
            acc = replace(
                self.base,
                glb_bytes=rng.choice(self.glb_candidates),
                wbuf_bytes=rng.choice(self.wbuf_candidates),
                shared=False,
            )
        elif self.mode == "shared":
            acc = replace(
                self.base,
                glb_bytes=rng.choice(self.shared_candidates),
                wbuf_bytes=0,
                shared=True,
            )
        else:
            raise ValueError(self.mode)
        if self.core_candidates:
            acc = self._with_cores(acc, rng.choice(self.core_candidates))
        return acc

    @staticmethod
    def _snap(value: float, cands: Sequence[int]) -> int:
        return min(cands, key=lambda c: abs(c - value))

    def blend(self, a: AcceleratorConfig, b: AcceleratorConfig,
              rng: random.Random) -> AcceleratorConfig:
        """Crossover of HW genes: average, snapped to the grid (§4.4.2)."""
        if self.mode == "fixed":
            acc = self.base
        elif self.mode == "separate":
            acc = replace(
                a,
                glb_bytes=self._snap((a.glb_bytes + b.glb_bytes) / 2,
                                     self.glb_candidates),
                wbuf_bytes=self._snap((a.wbuf_bytes + b.wbuf_bytes) / 2,
                                      self.wbuf_candidates),
            )
        else:
            acc = replace(
                a,
                glb_bytes=self._snap((a.glb_bytes + b.glb_bytes) / 2,
                                     self.shared_candidates),
            )
        if self.core_candidates:
            acc = self._with_cores(acc, self._snap(
                (a.weight_share_cores + b.weight_share_cores) / 2,
                self.core_candidates))
        return acc

    def mutate(self, acc: AcceleratorConfig, rng: random.Random,
               sigma_steps: float = 3.0) -> AcceleratorConfig:
        """mutation-DSE: normal perturbation around the current value (§4.4.3)."""

        def perturb(value: int, cands: Sequence[int]) -> int:
            step = cands[1] - cands[0] if len(cands) > 1 else 1
            return self._snap(rng.gauss(value, sigma_steps * step), cands)

        if self.mode == "fixed":
            out = self.base
        elif self.mode == "separate":
            out = replace(
                acc,
                glb_bytes=perturb(acc.glb_bytes, self.glb_candidates),
                wbuf_bytes=perturb(acc.wbuf_bytes, self.wbuf_candidates),
            )
        else:
            out = replace(
                acc,
                glb_bytes=perturb(acc.glb_bytes, self.shared_candidates))
        if self.core_candidates:
            out = self._with_cores(out, perturb(
                acc.weight_share_cores, self.core_candidates))
        return out


# ---------------------------------------------------------------------------
# genome
# ---------------------------------------------------------------------------

@dataclass
class Genome:
    groups: List[Set[int]]
    acc: AcceleratorConfig
    cost: float = math.inf
    plan: Optional[PlanCost] = None
    # lazy node->group index; rebuilt on demand after invalidate().  Excluded
    # from comparison/repr: it is derived state, never genome identity.
    _gid: Optional[List[int]] = field(default=None, repr=False, compare=False)

    def clone(self) -> "Genome":
        return Genome([set(s) for s in self.groups], self.acc)

    def membership(self, n: int) -> List[int]:
        """``membership(g.n)[v]`` = index of the group holding node ``v``.

        Built once per genome and shared by every crossover/mutate this
        genome participates in (the operators used to rebuild an O(n) dict
        per child).  Any code that rebinds or mutates ``groups`` must call
        :meth:`invalidate`; groups are disjoint by construction (normalize
        output), so "last group wins" below never actually ties.
        """
        gid = self._gid
        if gid is None or len(gid) != n:
            gid = [-1] * n
            for i, s in enumerate(self.groups):
                for v in s:
                    gid[v] = i
            self._gid = gid
        return gid

    def invalidate(self) -> None:
        """Drop the membership index after ``groups`` changed."""
        self._gid = None


# ---------------------------------------------------------------------------
# operators
# ---------------------------------------------------------------------------

def crossover(g: Graph, mom: Genome, dad: Genome, hw: HWSpace,
              rng: random.Random) -> Genome:
    parents = (mom, dad)
    # cached per-parent membership indexes: a parent is crossed many times
    # per generation, so the old per-call dict rebuild was O(n) * children
    gid_of = (mom.membership(g.n), dad.membership(g.n))

    decided = [-1] * g.n                  # node -> child group index
    child_groups: List[Set[int]] = []
    for v in g.topo_order():
        if decided[v] >= 0:
            continue
        p = rng.randrange(2)
        src_group = parents[p].groups[gid_of[p][v]]
        undecided: Set[int] = set()
        overlap: Set[int] = set()
        for u in src_group:
            (undecided if decided[u] < 0 else overlap).add(u)
        if overlap and rng.random() < 0.5:
            # Child-2 style: merge the undecided members into one subgraph of
            # an already-decided member
            tgt = decided[rng.choice(sorted(overlap))]
            child_groups[tgt] |= undecided
            for u in undecided:
                decided[u] = tgt
        else:
            # Child-1 style: split out a fresh subgraph
            idx = len(child_groups)
            child_groups.append(set(undecided))
            for u in undecided:
                decided[u] = idx
    groups = normalize(g, child_groups)
    return Genome(groups, hw.blend(mom.acc, dad.acc, rng))


def mutate(g: Graph, genome: Genome, hw: HWSpace, rng: random.Random,
           p_node: float = 0.35, p_split: float = 0.25, p_merge: float = 0.25,
           p_dse: float = 0.15) -> Genome:
    child = genome.clone()
    r = rng.random()
    groups = child.groups
    # the clone's groups equal the parent's, so the parent's cached
    # membership index answers node->group for the child's pre-mutation
    # state — no per-child O(n * groups) dict rebuild
    if r < p_node and g.n > 1:
        # modify-node: reassign a random node to a neighbour subgraph or a new one
        v = rng.randrange(g.n)
        gid = genome.membership(g.n)
        src = gid[v]
        neigh = {gid[u] for u in (g.preds(v) + g.succs(v))} - {src}
        choices = sorted(neigh) + ["new"]
        pick = rng.choice(choices)
        groups[src].discard(v)
        if pick == "new":
            groups.append({v})
        else:
            groups[pick].add(v)
        child.groups = normalize(g, [s for s in groups if s])
    elif r < p_node + p_split:
        multi = [i for i, s in enumerate(groups) if len(s) > 1]
        if multi:
            i = rng.choice(multi)
            pieces = rng.choice([2, 2, 3])
            rest = [s for j, s in enumerate(groups) if j != i]
            rest.extend(split_group_topo(g, groups[i], pieces))
            child.groups = normalize(g, rest)
    elif r < p_node + p_split + p_merge and len(groups) > 1:
        # merge two adjacent subgraphs (prefer connected pairs)
        gid = genome.membership(g.n)
        pairs = {(min(gid[e.src], gid[e.dst]), max(gid[e.src], gid[e.dst]))
                 for e in g.edges if gid[e.src] != gid[e.dst]}
        if pairs:
            a, b = rng.choice(sorted(pairs))
            groups[a] |= groups[b]
            del groups[b]
            child.groups = normalize(g, groups)
    else:
        child.acc = hw.mutate(child.acc, rng)
    return child


# ---------------------------------------------------------------------------
# the Cocco GA loop
# ---------------------------------------------------------------------------

@dataclass
class SearchResult:
    best: Genome
    history: List[Tuple[int, float]]            # (samples, best cost so far)
    population_log: List[List[Tuple[int, float, float]]]  # per-gen (bufsz, metric, cost)
    samples: int
    evaluations: int


def _emit_generation_telemetry(rec, best: "Genome",
                               evaluated: Sequence["Genome"],
                               pop: Sequence["Genome"]) -> None:
    """Per-generation convergence samples on an *enabled* recorder only —
    the disabled path never pays for the diversity signature scan."""
    if best is not None and math.isfinite(best.cost):
        rec.sample("ga.best_cost", best.cost)
    finite = [ind.cost for ind in evaluated if math.isfinite(ind.cost)]
    if finite:
        rec.sample("ga.mean_cost", sum(finite) / len(finite))
    # population diversity: fraction of distinct partition schemes
    sigs = {tuple(sorted(tuple(sorted(s)) for s in ind.groups))
            for ind in pop}
    rec.sample("ga.diversity", len(sigs) / max(len(pop), 1))


def evaluate_genomes(g: Graph, genomes: Sequence[Genome], obj: Objective,
                     ev: CachedEvaluator) -> None:
    """Batched genome evaluation: collect → submit → apply.

    Phase 1 runs the in-situ split repair (§4.4.4) for the whole batch, one
    evaluator batch per repair round; phase 2 costs every repaired plan in a
    single batch.  Repaired groups, plan, and cost are written back to each
    genome Lamarckian-style — exactly what the old per-genome ``_evaluate``
    did, but with "what to evaluate" separated from "how it's executed" so
    the engine's executor can parallelize within a generation.
    """
    if not genomes:
        return
    repaired = split_to_fit_batch(
        g, [(genome.groups, genome.acc) for genome in genomes], ev)
    for genome, groups in zip(genomes, repaired):
        genome.groups = groups
        genome.invalidate()  # repair rebound groups; drop the stale index
    plans = ev.plan_batch([(genome.groups, genome.acc)
                           for genome in genomes])
    for genome, plan in zip(genomes, plans):
        genome.plan = plan
        genome.cost = obj.cost(plan, genome.acc)


def run_ga(
    g: Graph,
    objective: Objective,
    hw: HWSpace,
    sample_budget: int = 50_000,
    population: int = 100,
    tournament_k: int = 4,
    crossover_frac: float = 0.5,
    elite: int = 2,
    seed: int = 0,
    out_tile: int = 1,
    init_groups: Optional[List[List[Set[int]]]] = None,
    log_populations: bool = False,
    ev: Optional[CachedEvaluator] = None,
) -> SearchResult:
    rng = random.Random(seed)
    ev = ev or CachedEvaluator(g, out_tile=out_tile)

    pop: List[Genome] = []
    if init_groups:
        for gr in init_groups[: population]:
            pop.append(Genome([set(s) for s in gr], hw.sample(rng)))
    while len(pop) < population:
        mode = rng.random()
        if mode < 0.2:
            groups = singleton_partition(g)
        else:
            groups = random_partition(g, rng,
                                      mean_size=rng.uniform(1.5, 6.0))
        pop.append(Genome(groups, hw.sample(rng)))

    samples = 0
    history: List[Tuple[int, float]] = []
    pop_log: List[List[Tuple[int, float, float]]] = []
    best: Optional[Genome] = None

    rec = obs.current()
    with rec.span("ga.generation", gen=0, population=len(pop)):
        evaluate_genomes(g, pop, objective, ev)
    for ind in pop:
        samples += 1
        if best is None or ind.cost < best.cost:
            best = ind.clone()
            best.cost, best.plan = ind.cost, ind.plan
        history.append((samples, best.cost))
    if rec.enabled:
        _emit_generation_telemetry(rec, best, pop, pop)

    gen = 0
    while samples < sample_budget:
        gen += 1
        with rec.span("ga.generation", gen=gen, samples=samples):
            # --- variation ---------------------------------------------
            offspring: List[Genome] = []
            n_children = population
            for _ in range(n_children):
                if rng.random() < crossover_frac and len(pop) >= 2:
                    mom, dad = rng.sample(pop, 2)
                    child = crossover(g, mom, dad, hw, rng)
                    if rng.random() < 0.5:
                        child = mutate(g, child, hw, rng)
                else:
                    child = mutate(g, rng.choice(pop), hw, rng)
                offspring.append(child)

            # --- evaluation: one engine batch per generation ------------
            # the budget cap is known up front (evaluation spends one
            # sample per child), so truncating *before* the batch
            # reproduces the serial early-break exactly
            evaluated = offspring[: sample_budget - samples]
            evaluate_genomes(g, evaluated, objective, ev)
            for ind in evaluated:
                samples += 1
                if ind.cost < best.cost:
                    best = ind.clone()
                    best.cost, best.plan = ind.cost, ind.plan
                history.append((samples, best.cost))

            # --- tournament selection over parents + offspring ----------
            pool = pop + evaluated
            new_pop: List[Genome] = sorted(pool, key=lambda i: i.cost)[:elite]
            while len(new_pop) < population:
                contenders = rng.sample(pool, min(tournament_k, len(pool)))
                new_pop.append(min(contenders, key=lambda i: i.cost))
            pop = new_pop
            if log_populations:
                pop_log.append([
                    (float(i.acc.buf_size_total),
                     float(i.plan.metric(objective.metric))
                     if i.plan else math.inf,
                     i.cost)
                    for i in pop
                ])
        if rec.enabled:
            _emit_generation_telemetry(rec, best, evaluated, pop)

    return SearchResult(best=best, history=history, population_log=pop_log,
                        samples=samples, evaluations=ev.evaluations)
