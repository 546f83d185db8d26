"""The plan zoo: precomputed ``ExploreResult`` archives for common specs.

``python -m repro_torch zoo build`` sweeps a curated grid — every ``netlib:``
model × a curated set of ``tpu:`` block workloads × standard objectives ×
a couple of strategies — through a :class:`ResultStore`, so the artifacts
are plain spec-addressed store entries.  That makes the build *resumable*
(already-archived specs replay instead of re-searching; interrupt and
re-run freely) and the zoo directly mountable by the plan server
(``serve-plans --zoo-dir``) as a read-only read-through tier: common
requests are answered from disk in milliseconds and never search.

``zoo ls`` reports grid coverage (which points are archived vs missing);
``zoo verify`` checks replay integrity of every artifact in the directory:
it must parse, its embedded spec must hash to its filename, its workload
must still resolve to the graph it was searched on (fingerprint check), and
its recorded cost must equal re-scoring its plan under its objective.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.api.result import ExploreResult
from repro_torch.api.spec import ExploreSpec, GAOptions
from repro_torch.api.store import ResultStore, graph_fingerprint, spec_key
from repro_torch.api.workloads import build_workload, list_workloads
from repro_torch.core.ga import HWSpace, Objective

# Curated tpu: block workloads: one representative decode/prefill block per
# covered architecture family (dense GQA, MoE, SSM, enc-dec).  Layer 0 at a
# production-ish token count; the full per-layer sweep stays a user-driven
# `zoo build --workloads` away.
CURATED_TPU_WORKLOADS: Tuple[str, ...] = (
    "tpu:gemma3-4b:0?tokens=4096",
    "tpu:glm4-9b:0?tokens=4096",
    "tpu:tinyllama-1.1b:0?tokens=4096",
    "tpu:whisper-base:0?tokens=1500",
)

#: standard objectives: partition-only EMA (Formula 1) and the paper's
#: energy co-objective (Formula 2, alpha=0.002)
STANDARD_OBJECTIVES: Tuple[Tuple[str, Optional[float]], ...] = (
    ("ema", None),
    ("energy", 0.002),
)

STANDARD_STRATEGIES: Tuple[str, ...] = ("greedy", "ga")

#: reduced default budget: the zoo is a serving cache, not the paper sweep;
#: rebuild with --budget for FULL-quality plans
DEFAULT_BUDGET = 2_000


def default_zoo_workloads() -> List[str]:
    """Every ``netlib:`` model plus the curated ``tpu:`` blocks."""
    netlib = [uri for uri, _ in list_workloads("netlib", concrete=True)]
    return netlib + list(CURATED_TPU_WORKLOADS)


def zoo_specs(workloads: Optional[Sequence[str]] = None,
              strategies: Sequence[str] = STANDARD_STRATEGIES,
              objectives: Sequence[Tuple[str, Optional[float]]]
              = STANDARD_OBJECTIVES,
              budget: int = DEFAULT_BUDGET,
              seed: int = 0,
              hw_mode: str = "fixed") -> List[ExploreSpec]:
    """The zoo grid as concrete :class:`ExploreSpec` rows (deterministic
    order: workload-major, then objective, then strategy)."""
    specs: List[ExploreSpec] = []
    for workload in (workloads if workloads is not None
                     else default_zoo_workloads()):
        for metric, alpha in objectives:
            for strategy in strategies:
                specs.append(ExploreSpec(
                    workload=workload,
                    strategy=strategy,
                    objective=Objective(metric=metric, alpha=alpha),
                    hw=HWSpace(mode=hw_mode),
                    sample_budget=budget,
                    seed=seed,
                    options=(GAOptions(population=50)
                             if strategy == "ga" else None),
                ))
    return specs


@dataclass
class ZooBuildReport:
    """What one ``zoo build`` pass did."""

    built: int = 0          # searched + archived this pass
    replayed: int = 0       # already archived (resume hit)
    failed: int = 0
    errors: List[str] = None  # type: ignore[assignment]

    def __post_init__(self) -> None:
        if self.errors is None:
            self.errors = []

    @property
    def total(self) -> int:
        return self.built + self.replayed + self.failed


def build_zoo(store: ResultStore, specs: Sequence[ExploreSpec],
              progress: Optional[Callable[[str], None]] = None,
              device: str = "cuda",
              ) -> ZooBuildReport:
    """Archive every spec into ``store`` (resumable: store hits skip),
    searching on ``device`` (``"cuda"``, the default, or ``"cpu"``).

    Uses :func:`repro_torch.serve.plans.resolve_plan`, so concurrent builders
    sharing one directory cooperate through the store's per-key lock
    instead of double-searching.
    """
    from .plans import resolve_plan

    say = progress or (lambda _msg: None)
    report = ZooBuildReport()
    for i, spec in enumerate(specs):
        label = f"[{i + 1}/{len(specs)}] {spec.workload} " \
                f"{spec.strategy}/{spec.objective.metric}"
        try:
            res, source = resolve_plan(spec, store=store, device=device)
        except (ValueError, KeyError, RuntimeError) as err:
            report.failed += 1
            report.errors.append(f"{label}: {err}")
            say(f"{label}: FAILED ({err})")
            continue
        if source == "search":
            report.built += 1
            say(f"{label}: built (cost={res.cost:.4g})")
        else:
            report.replayed += 1
            say(f"{label}: archived (replayed, cost={res.cost:.4g})")
    return report


def zoo_coverage(store: Optional[ResultStore], specs: Sequence[ExploreSpec]
                 ) -> List[Dict[str, str]]:
    """One row per grid point: archived or missing (for ``zoo ls``).
    ``store=None`` (the zoo directory does not exist yet) marks every
    point missing."""
    rows = []
    for spec in specs:
        key = spec_key(spec)
        present = (store is not None
                   and (store.root / f"{key}.json").exists())
        rows.append({
            "workload": spec.workload,
            "strategy": spec.strategy,
            "objective": spec.objective.metric
            + ("" if spec.objective.alpha is None
               else f":{spec.objective.alpha:g}"),
            "budget": str(spec.sample_budget),
            "key": key[:16],
            "status": "archived" if present else "missing",
        })
    return rows


def verify_zoo(store: ResultStore,
               rebuild_graphs: bool = True) -> List[str]:
    """Replay-integrity check of every artifact in the zoo directory.

    Returns a list of problems (empty == everything verifies):

    * the artifact parses as a current-version ``ExploreResult`` and its
      embedded spec hashes to its filename (spec-addressing intact);
    * with ``rebuild_graphs`` (default), the workload URI still resolves to
      a graph with the archived ``graph_sha`` (the plan still applies to
      what the URI builds today);
    * the archived scalar cost equals re-scoring the archived plan under
      the archived objective (the replay really is the search's answer).
    """
    problems: List[str] = []
    fingerprints: Dict[str, str] = {}
    for entry in store.entries(peek=False):
        name = entry.path.name
        try:
            res = ExploreResult.from_json(entry.path.read_text())
        except (ValueError, KeyError, TypeError) as err:
            problems.append(f"{name}: unreadable artifact ({err})")
            continue
        if res.spec is None:
            problems.append(f"{name}: artifact has no embedded spec")
            continue
        if spec_key(res.spec) != entry.key:
            problems.append(
                f"{name}: embedded spec hashes to "
                f"{spec_key(res.spec)[:16]}..., not its filename")
            continue
        if res.plan is not None:
            recost = res.objective.cost(res.plan, res.acc)
            if recost != res.cost:
                problems.append(
                    f"{name}: archived cost {res.cost!r} != re-scored "
                    f"plan cost {recost!r}")
        if rebuild_graphs:
            sha = res.meta.get("graph_sha")
            if sha is not None:
                uri = res.spec.workload
                try:
                    if uri not in fingerprints:
                        fingerprints[uri] = graph_fingerprint(
                            build_workload(uri))
                except (ValueError, KeyError, RuntimeError) as err:
                    problems.append(
                        f"{name}: workload {uri!r} no longer resolves "
                        f"({err})")
                    continue
                if fingerprints[uri] != sha:
                    problems.append(
                        f"{name}: workload {uri!r} now builds a different "
                        f"graph than the archived plan was searched on")
    return problems
