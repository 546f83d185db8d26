"""Built-in strategies + the ``run``/``compare`` entry points.

All six search methods from the paper's evaluation run under the same
registry and return :class:`ExploreResult`:

* ``ga``        — Cocco's genetic co-exploration (:func:`repro_torch.core.ga.run_ga`)
* ``greedy``    — Halide-style greedy merging
* ``dp``        — Irregular-NN DP over depth order
* ``enum``      — exact (budgeted) enumeration over ideals
* ``sa``        — simulated annealing
* ``two_step``  — RS+GA / GS+GA decoupled capacity search

Fixed-hardware methods (``greedy``/``dp``/``enum``) evaluate at
``spec.hw.base`` regardless of the HW-space mode.
"""

from __future__ import annotations

import contextvars
import math
import os
from concurrent.futures import ProcessPoolExecutor, as_completed
from contextlib import nullcontext
from dataclasses import replace
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple, Union

from repro_torch.core.baselines import (
    dp_partition,
    enumerate_partitions,
    greedy_partition,
    run_sa,
    run_two_step,
)
from repro_torch.core.cost import CachedEvaluator, PlanCost, SubgraphCost
from repro_torch.core.ga import SearchResult, run_ga
from repro_torch.core.graph import Graph
from repro_torch.obs import recorder as obs

from .registry import get_strategy, list_strategies, register_strategy
from .result import ExploreResult
from .spec import (
    DPOptions,
    EnumOptions,
    ExploreSpec,
    GAOptions,
    GreedyOptions,
    SAOptions,
    TwoStepOptions,
)
from .store import ResultStore, graph_fingerprint, spec_key
from .workloads import build_workload  # re-export: the one resolution path


# The store of the innermost active run(), visible to strategies that launch
# nested sub-searches (GAOptions.seed_from baselines, seed_from_keys lookups)
# so those share — and populate — the same spec-addressed cache instead of
# re-searching their seeds on every sweep point.  A contextvar keeps it
# correct per-thread (the plan server runs searches on a worker pool).
_ACTIVE_STORE: contextvars.ContextVar[Optional[ResultStore]] = \
    contextvars.ContextVar("repro_active_store", default=None)


def active_store() -> Optional[ResultStore]:
    """The :class:`ResultStore` of the innermost in-flight :func:`run`,
    or ``None``.  For strategies that issue nested sub-searches."""
    return _ACTIVE_STORE.get()


def _make_evaluator(g: Graph, out_tile: int, eval_backend: Optional[str],
                    eval_jobs: int,
                    struct_cache_dir: Optional[str] = None,
                    device: str = "cuda") -> CachedEvaluator:
    """Build an evaluator whose executor matches the requested backend
    (``device`` places the ``torch`` backend).

    ``struct_cache_dir`` (or ``$REPRO_STRUCT_CACHE_DIR``) attaches a
    disk-backed :class:`~repro_torch.core.structcache.StructureCache` as the warm
    tier behind the in-memory canonical structure memo; unset means no
    filesystem traffic, exactly like the result store.
    """
    from repro_torch.core.engine import make_executor

    cache_dir = struct_cache_dir or os.environ.get("REPRO_STRUCT_CACHE_DIR")
    struct_cache = None
    if cache_dir:
        from repro_torch.core.structcache import StructureCache

        struct_cache = StructureCache(cache_dir)
    return CachedEvaluator(g, out_tile=out_tile,
                           executor=make_executor(eval_backend, eval_jobs,
                                                  device),
                           struct_cache=struct_cache)


def _counters_delta(before: Dict[str, object],
                    after: Dict[str, object]) -> Dict[str, object]:
    """Numeric counter deltas (so a shared evaluator's prior activity does
    not leak into one run's profile); non-numeric fields pass through."""
    out: Dict[str, object] = {}
    for k, v in after.items():
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            out[k] = v
        else:
            b = before.get(k, 0)
            out[k] = v - b if isinstance(b, (int, float)) else v
    return out


def run(spec: ExploreSpec, graph: Optional[Graph] = None,
        ev: Optional[CachedEvaluator] = None,
        store: Optional[ResultStore] = None,
        eval_backend: Optional[str] = None, eval_jobs: int = 1,
        profile: bool = False,
        struct_cache_dir: Optional[str] = None,
        device: str = "cuda",
        **runtime) -> ExploreResult:
    """Run ``spec.strategy`` on ``spec`` and return an :class:`ExploreResult`.

    ``graph`` overrides workload-name resolution (for custom graphs);
    ``ev`` shares one :class:`CachedEvaluator` across calls (e.g. from
    :func:`compare`).  ``store`` consults a spec-addressed
    :class:`~repro_torch.api.store.ResultStore` first and persists the result on a
    miss; it is bypassed when ``runtime`` extras are passed, because those
    are not part of the spec and the result would not be reproducible from
    its address.  ``runtime`` carries non-serializable extras a strategy may
    accept (the GA takes ``init_groups``).

    ``eval_backend``/``eval_jobs`` pick the evaluation-engine executor for
    batched in-strategy cost queries (``serial`` | ``process`` | ``vector``
    | ``torch``, default ``torch``; ``eval_jobs`` sizes the ``process``
    pool — see :func:`repro_torch.core.engine.make_executor`); ``device``
    (``"cuda"``, the default, or ``"cpu"``) places the ``torch`` backend, so
    a bare ``run(spec)`` evaluates on the card and raises without one.
    Every backend returns identical results, so
    these are runtime knobs, deliberately *not* part of the spec (a stored
    artifact addresses what was searched, not how it was scheduled).  They
    apply when ``run`` builds the evaluator; a caller-provided ``ev`` keeps
    its own executor.

    ``result.evaluations`` is set here, uniformly for every strategy, to the
    number of *distinct* (subgraph, hardware-point) cost-model queries the
    strategy issued — see :class:`ExploreResult` for the exact semantics.

    ``profile=True`` attaches ``result.meta["profile"]``: the search's wall
    time plus the evaluator counter deltas it caused
    (:meth:`CachedEvaluator.counters` — structure raw/canonical/disk hits,
    misses, and ``derive_schedule`` seconds).  The profile is attached
    *after* the store write, so stored artifacts never embed timings and
    stay byte-stable across machines; a store hit returns the cached
    artifact without a profile (no search ran).  ``struct_cache_dir``
    (default ``$REPRO_STRUCT_CACHE_DIR``) adds a disk-backed warm tier for
    canonical structures when ``run`` builds the evaluator.
    """
    from .workloads import workload_is_stable

    use_store = store is not None and not runtime
    if use_store:
        cached = store.get(spec)
        if cached is not None:
            # Store keys carry no graph identity, so refuse another graph's
            # artifact: a custom graph= shares only the workload *label*
            # with the spec, and a non-stable workload URI (file: — the
            # file can change under an unchanged URI) must be re-resolved
            # and fingerprint-checked before its artifact replays.
            g_check = graph
            if g_check is None and not workload_is_stable(spec.workload):
                g_check = graph = build_workload(spec.workload)
            if (g_check is None
                    or cached.meta.get("graph_sha")
                    in (None, graph_fingerprint(g_check))):
                obs.add("store.hit")
                return cached
    if graph is not None:
        g = graph
    else:
        with obs.span("resolve-workload", workload=spec.workload):
            g = build_workload(spec.workload)
    created_ev = ev is None
    if created_ev:
        ev = _make_evaluator(g, spec.out_tile, eval_backend, eval_jobs,
                             struct_cache_dir, device)
    entry = get_strategy(spec.strategy)
    options = spec.options
    if options is None and entry.options_cls is not None:
        options = entry.options_cls()
    if entry.options_cls is not None and not isinstance(options,
                                                        entry.options_cls):
        raise TypeError(
            f"strategy {spec.strategy!r} expects options of type "
            f"{entry.options_cls.__name__}, got {type(options).__name__}"
        )
    # ``--profile`` is a thin view over the telemetry recorder: with no
    # ambient recorder installed, profiling brings its own (the strategy
    # span's duration *is* the reported wall time).  Telemetry never touches
    # the result — the profile dict is attached after the store write, and
    # counter deltas flow only into the recorder side-channel.
    rec = obs.current()
    if profile and not rec.enabled:
        rec = obs.Recorder()
    token = _ACTIVE_STORE.set(store if use_store else None)
    counters_before = ev.counters() if rec.enabled else None
    try:
        with ev.count_run() as touched, \
                (obs.recording(rec) if rec.enabled else nullcontext()), \
                rec.span(f"strategy:{spec.strategy}",
                         workload=spec.workload, strategy=spec.strategy,
                         budget=spec.sample_budget, seed=spec.seed) as sp:
            result = entry.fn(spec, options, g, ev, **runtime)
    finally:
        _ACTIVE_STORE.reset(token)
        if created_ev:
            ev.close()  # release executor pools; the cache dies with ev
    result.evaluations = len(touched)
    result.spec = spec
    result.meta.setdefault("graph", g.name)
    result.meta.setdefault("graph_sha", graph_fingerprint(g))
    if use_store:
        store.put(spec, result)
    if rec.enabled:
        prof = _counters_delta(counters_before, ev.counters())
        rec.merge_counters(prof, prefix="evaluator.")
        if profile:
            prof["wall_s"] = sp.dur_s
            result.meta["profile"] = prof
    return result


def _resolve_compare_specs(
    spec: ExploreSpec,
    strategies: Optional[Iterable[Union[str, ExploreSpec]]],
) -> List[ExploreSpec]:
    items = list(strategies) if strategies is not None else list_strategies()
    subs: List[ExploreSpec] = []
    for item in items:
        if isinstance(item, ExploreSpec):
            if (item.workload != spec.workload
                    or item.out_tile != spec.out_tile):
                raise ValueError(
                    "compare() spec items must share the primary spec's "
                    f"workload/out_tile; got {item.workload!r}/"
                    f"{item.out_tile} vs {spec.workload!r}/{spec.out_tile}")
            subs.append(item)
        else:
            subs.append(spec if item == spec.strategy
                        else replace(spec, strategy=item, options=None))
    return subs


def compare(spec: ExploreSpec,
            strategies: Optional[Iterable[Union[str, ExploreSpec]]] = None,
            graph: Optional[Graph] = None,
            ev: Optional[CachedEvaluator] = None,
            jobs: int = 1,
            store: Optional[ResultStore] = None,
            eval_backend: Optional[str] = None,
            eval_jobs: int = 1,
            struct_cache_dir: Optional[str] = None,
            device: str = "cuda") -> List[ExploreResult]:
    """Run several strategies on one spec, sharing a single evaluator cache.

    ``strategies`` items are strategy names (run with their default options,
    except ``spec.strategy`` which keeps ``spec.options``) or fully-formed
    :class:`ExploreSpec` variants sharing the primary spec's workload (for
    per-strategy budgets/options, as the benchmarks do).  Returns results in
    the order given (rank by ``cost`` to get a table).

    ``jobs > 1`` runs the strategies in worker processes via
    :class:`~concurrent.futures.ProcessPoolExecutor`: each worker searches
    against a cold per-worker :class:`CachedEvaluator` whose entries are
    merged back into ``ev`` on join.  Because every strategy is
    deterministic given its spec and evaluation counts are cache-warmth
    independent, the parallel path returns bitwise-identical results to the
    serial path.  Strategies registered at import time (the built-ins, or
    anything importable from the worker) are supported; with the ``fork``
    start method (Linux default) runtime-registered strategies work too.
    When torch has been imported, workers start via ``forkserver`` instead
    (see :func:`repro_torch.core.engine.pool_mp_context`) so no process
    forks a parent that holds torch's threads or a CUDA context.

    ``store`` serves store hits in the parent without spawning a worker and
    persists every miss, so an interrupted comparison resumes where it
    stopped.

    ``eval_backend``/``eval_jobs`` select the evaluation-engine executor for
    *within-strategy* batches (a different axis than ``jobs``, which fans
    out whole strategies), default ``torch`` on ``device``.  They configure
    the shared evaluator on the serial path; with ``jobs > 1`` every worker
    builds the same executor on the same device (each worker opens its own
    CUDA context), and the ``process`` backend is refused there with a
    :class:`ValueError` — process pools nested inside workers oversubscribe
    cores.

    ``struct_cache_dir`` (default ``$REPRO_STRUCT_CACHE_DIR``) attaches the
    disk-backed canonical structure cache; with ``jobs > 1`` each worker
    opens the same directory (writes are atomic, so sharing is safe) and
    additionally ships its in-memory canonical entries back on join
    (:meth:`CachedEvaluator.merge_structures`), mirroring the cost-memo
    merge.
    """
    subs = _resolve_compare_specs(spec, strategies)
    parallel = bool(jobs and jobs > 1 and len(subs) > 1)
    if parallel and eval_backend == "process":
        raise ValueError(
            "compare jobs > 1 runs strategies in worker processes and cannot "
            "nest the process eval backend's pool inside them; pass another "
            "eval backend (serial, vector or torch)")
    g = graph if graph is not None else build_workload(spec.workload)
    created_ev = ev is None
    if created_ev:
        ev = _make_evaluator(g, spec.out_tile, eval_backend, eval_jobs,
                             struct_cache_dir, device)
    try:
        if parallel:
            return _compare_parallel(subs, g, ev, jobs, store,
                                     struct_cache_dir, eval_backend, device)
        return [run(sub, graph=g, ev=ev, store=store) for sub in subs]
    finally:
        if created_ev:
            ev.close()


def _compare_worker(
    spec_json: str, graph: Optional[Graph], store_dir: Optional[str],
    struct_cache_dir: Optional[str], eval_backend: Optional[str],
    device: str,
) -> Tuple[ExploreResult, Dict[Tuple, SubgraphCost], Dict[Tuple, object]]:
    """Top-level (picklable) worker: run one spec on a cold evaluator whose
    executor is the parent's ``eval_backend`` on ``device``.

    Returns the result plus the worker evaluator's memo table and its
    canonical structure table, so the parent can merge both
    (``CachedEvaluator.merge_cache`` / ``merge_structures``) and later
    serial runs still benefit from the work done in workers.
    """
    spec = ExploreSpec.from_json(spec_json)
    g = graph if graph is not None else build_workload(spec.workload)
    ev = _make_evaluator(g, spec.out_tile, eval_backend, 1, struct_cache_dir,
                         device)
    worker_store = ResultStore(store_dir) if store_dir else None
    result = run(spec, graph=g, ev=ev, store=worker_store)
    return result, ev.cache_snapshot(), ev.structure_snapshot()


def _compare_parallel(subs: List[ExploreSpec], g: Graph,
                      ev: CachedEvaluator, jobs: int,
                      store: Optional[ResultStore],
                      struct_cache_dir: Optional[str],
                      eval_backend: Optional[str], device: str,
                      ) -> List[ExploreResult]:
    from repro_torch.core.engine import pool_mp_context

    results: List[Optional[ExploreResult]] = [None] * len(subs)
    pending = list(range(len(subs)))
    if store is not None:
        g_sha = graph_fingerprint(g)
        missing = []
        for i in pending:
            cached = store.get(subs[i])
            if cached is not None and cached.meta.get("graph_sha") in (None,
                                                                       g_sha):
                results[i] = cached
            else:
                missing.append(i)
        pending = missing
    # identical specs in one batch (e.g. two searches that chose the same
    # hardware point) search once and share the result
    first_of: Dict[str, int] = {}
    duplicates: Dict[int, int] = {}
    unique = []
    for i in pending:
        key = spec_key(subs[i])
        if key in first_of:
            duplicates[i] = first_of[key]
        else:
            first_of[key] = i
            unique.append(i)
    if unique:
        store_dir = str(store.root) if store is not None else None
        with ProcessPoolExecutor(
                max_workers=min(jobs, len(unique)),
                mp_context=pool_mp_context()) as pool:
            futures = {
                pool.submit(_compare_worker, subs[i].to_json(), g, store_dir,
                            struct_cache_dir, eval_backend, device):
                i for i in unique
            }
            for fut in as_completed(futures):
                result, cache, structs = fut.result()
                results[futures[fut]] = result
                ev.merge_cache(cache)
                ev.merge_structures(structs)
    for i, j in duplicates.items():
        results[i] = results[j]
    return [r for r in results if r is not None]


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _from_search(spec: ExploreSpec, res: SearchResult,
                 **meta) -> ExploreResult:
    # ``evaluations`` is left 0 here: run() overwrites it uniformly with the
    # distinct-query count of the whole strategy invocation
    best = res.best
    return ExploreResult(
        workload=spec.workload,
        strategy=spec.strategy,
        groups=best.groups,
        acc=best.acc,
        plan=best.plan,
        cost=best.cost,
        objective=spec.objective,
        history=res.history,
        samples=res.samples,
        population_log=res.population_log,
        meta=dict(meta),
    )


def _fixed_point(spec: ExploreSpec, groups: Sequence[Set[int]],
                 plan: PlanCost, n_eval: int, **meta) -> ExploreResult:
    acc = spec.hw.base
    cost = spec.objective.cost(plan, acc)
    return ExploreResult(
        workload=spec.workload,
        strategy=spec.strategy,
        groups=[set(s) for s in groups],
        acc=acc,
        plan=plan,
        cost=cost,
        objective=spec.objective,
        history=[(max(n_eval, 1), cost)],
        samples=n_eval,
        meta=dict(meta),
    )


# ---------------------------------------------------------------------------
# built-in strategies
# ---------------------------------------------------------------------------

def _store_seed_groups(opts: GAOptions, spec: ExploreSpec,
                       g: Graph) -> List[List[Set[int]]]:
    """Resolve ``opts.seed_from_keys`` against the active store: each key
    names an archived result (any strategy/budget) whose groups warm-start
    the population.  The archived partition must actually cover this graph,
    or a key pointing at a different workload would silently poison the
    initial population."""
    if not opts.seed_from_keys:
        return []
    store = active_store()
    if store is None:
        raise ValueError(
            "GAOptions.seed_from_keys needs a result store at run time "
            "(pass store= / --store-dir); keys cannot resolve without one")
    seeds: List[List[Set[int]]] = []
    every_node = set(range(g.n))
    for key in opts.seed_from_keys:
        seeded = store.get_by_key(key)
        if seeded is None:
            raise ValueError(
                f"seed_from_keys entry {key[:16]}... not found in "
                f"store[{store.root}] (run the reduced spec first, or check "
                f"`python -m repro store ls --json`)")
        covered = set().union(*seeded.groups) if seeded.groups else set()
        if covered != every_node:
            raise ValueError(
                f"seed_from_keys entry {key[:16]}... partitions workload "
                f"{seeded.workload!r}, which does not cover "
                f"{spec.workload!r} ({len(covered)} vs {g.n} nodes)")
        seeds.append(seeded.groups)
    return seeds


@register_strategy("ga", GAOptions)
def _strategy_ga(spec: ExploreSpec, opts: GAOptions, g: Graph,
                 ev: CachedEvaluator, init_groups=None) -> ExploreResult:
    seeds = [list(gr) for gr in init_groups] if init_groups else []
    for name in opts.seed_from:
        if name == spec.strategy:
            raise ValueError(
                f"seed_from cannot include the running strategy {name!r}")
        # Baseline seed searches always run (so the outer result's
        # `evaluations` stays independent of store warmth) but publish
        # write-through into the active store: the sweep's reduced baseline
        # specs become store hits for every later top-level run/compare.
        seeded = run(replace(spec, strategy=name, options=None),
                     graph=g, ev=ev)
        store = active_store()
        if (store is not None and seeded.spec is not None
                and seeded.spec not in store):
            store.put(seeded.spec, seeded)
        if seeded.groups:
            seeds.append(seeded.groups)
    seeds.extend(_store_seed_groups(opts, spec, g))
    res = run_ga(
        g, spec.objective, spec.hw,
        sample_budget=spec.sample_budget,
        population=opts.population,
        tournament_k=opts.tournament_k,
        crossover_frac=opts.crossover_frac,
        elite=opts.elite,
        seed=spec.seed,
        out_tile=spec.out_tile,
        init_groups=[[set(s) for s in gr] for gr in seeds] or None,
        log_populations=opts.log_populations,
        ev=ev,
    )
    return _from_search(spec, res, seeded_from=list(opts.seed_from),
                        seeded_from_keys=list(opts.seed_from_keys))


@register_strategy("greedy", GreedyOptions)
def _strategy_greedy(spec: ExploreSpec, opts: GreedyOptions, g: Graph,
                     ev: CachedEvaluator) -> ExploreResult:
    groups, plan, n_eval = greedy_partition(
        g, spec.hw.base, spec.objective, out_tile=spec.out_tile, ev=ev,
        eval_budget=opts.eval_budget)
    return _fixed_point(spec, groups, plan, n_eval)


@register_strategy("dp", DPOptions)
def _strategy_dp(spec: ExploreSpec, opts: DPOptions, g: Graph,
                 ev: CachedEvaluator) -> ExploreResult:
    groups, plan, n_eval = dp_partition(
        g, spec.hw.base, spec.objective, out_tile=spec.out_tile, ev=ev)
    return _fixed_point(spec, groups, plan, n_eval)


@register_strategy("enum", EnumOptions)
def _strategy_enum(spec: ExploreSpec, opts: EnumOptions, g: Graph,
                   ev: CachedEvaluator) -> ExploreResult:
    er = enumerate_partitions(
        g, spec.hw.base, spec.objective, out_tile=spec.out_tile,
        state_budget=opts.state_budget, ev=ev)
    meta = {"complete": er.complete, "states": er.states}
    if er.groups is None or er.plan is None:
        return ExploreResult(
            workload=spec.workload, strategy=spec.strategy, groups=[],
            acc=spec.hw.base, plan=None, cost=math.inf,
            objective=spec.objective, history=[], samples=er.states,
            meta=meta)
    return _fixed_point(spec, er.groups, er.plan, er.states, **meta)


@register_strategy("sa", SAOptions)
def _strategy_sa(spec: ExploreSpec, opts: SAOptions, g: Graph,
                 ev: CachedEvaluator) -> ExploreResult:
    res = run_sa(
        g, spec.objective, spec.hw, sample_budget=spec.sample_budget,
        t0=opts.t0, t_end=opts.t_end, seed=spec.seed,
        out_tile=spec.out_tile, ev=ev)
    return _from_search(spec, res)


@register_strategy("two_step", TwoStepOptions)
def _strategy_two_step(spec: ExploreSpec, opts: TwoStepOptions, g: Graph,
                       ev: CachedEvaluator) -> ExploreResult:
    # the shared evaluator now flows into the per-capacity inner GA runs, so
    # their queries are counted (and cached) like every other strategy's
    res = run_two_step(
        g, spec.objective, spec.hw, sampler=opts.sampler,
        capacity_samples=opts.capacity_samples,
        samples_per_capacity=opts.samples_per_capacity,
        seed=spec.seed, out_tile=spec.out_tile, ev=ev)
    return _from_search(spec, res, sampler=opts.sampler)


# ---------------------------------------------------------------------------
# H100 planning (wraps the execution-planner adapter)
# ---------------------------------------------------------------------------

def plan_h100(arch: str, tokens: int = 8192, layer_idx: Optional[int] = None,
              sample_budget: int = 3_000, seed: int = 0,
              device: str = "cuda"):
    """Run Cocco as the H100's execution planner for one architecture.

    Thin wrapper over :func:`repro_torch.core.h100_adapter.plan_architecture`
    so callers (CLI ``plan-h100``) go through one surface; ``device``
    places the GA's cost batches (``"cuda"``: one B1 launch a generation).
    """
    from repro_torch.configs import get_config
    from repro_torch.core.h100_adapter import plan_architecture

    cfg = get_config(arch)
    return plan_architecture(cfg, tokens_local=tokens, layer_idx=layer_idx,
                             sample_budget=sample_budget, seed=seed,
                             device=device)
