"""`ExploreResult`: the common, serializable output of every strategy.

Superset of the legacy ``CoccoResult``: groups, hardware point, plan,
scalar cost, convergence history, sample/evaluation counts, the per-strategy
metadata (``meta``), and the originating :class:`ExploreSpec` — so a result
written to JSON is a self-contained, reproducible artifact.
"""

from __future__ import annotations

import json
import math
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional, Set, Tuple

from repro_torch.core.cost import AcceleratorConfig, PlanCost, SubgraphCost
from repro_torch.core.ga import Objective

from .spec import (
    ExploreSpec,
    acc_from_dict,
    acc_to_dict,
    objective_from_dict,
    objective_to_dict,
)

RESULT_VERSION = 1


def plan_to_dict(plan: Optional[PlanCost]) -> Optional[Dict[str, Any]]:
    if plan is None:
        return None
    return {
        "acc": acc_to_dict(plan.acc),
        "subgraphs": [asdict(s) for s in plan.subgraphs],
    }


def plan_from_dict(d: Optional[Dict[str, Any]]) -> Optional[PlanCost]:
    if d is None:
        return None
    subs = [SubgraphCost(**{**s, "nodes": tuple(s["nodes"])})
            for s in d["subgraphs"]]
    return PlanCost(subgraphs=subs, acc=acc_from_dict(d["acc"]))


@dataclass
class ExploreResult:
    """What :func:`repro_torch.api.run` returns for every strategy.

    Field semantics worth pinning down:

    * ``samples`` — how many candidate *plans* the strategy considered (GA/SA
      genomes, greedy merge attempts, enum states, ...); the x-axis of
      ``history``.
    * ``evaluations`` — how many **distinct** cost-model queries the run
      issued: unique (subgraph node-set, hardware-point) pairs sent to the
      :class:`~repro_torch.core.cost.CachedEvaluator`, *including* nested
      sub-searches (a ``seed_from`` GA's baseline runs, ``two_step``'s
      per-capacity inner GAs).  Distinct queries — not raw cache misses — so
      the number does not depend on evaluator cache warmth: a strategy
      reports the same ``evaluations`` whether it ran alone, after other
      strategies on a shared evaluator (serial :func:`repro_torch.api.compare`),
      or in a cold worker process (``compare(jobs=N)``).  A run replayed
      from a :class:`~repro_torch.api.store.ResultStore` returns the archived
      result unchanged, so this field then reports the original search's
      count even though no new evaluation happened.
    * ``cost`` — ``objective.cost(plan, acc)``; ``math.inf`` when no feasible
      plan was found (then ``plan`` is ``None``).
    """

    workload: str
    strategy: str
    groups: List[Set[int]]
    acc: AcceleratorConfig
    plan: Optional[PlanCost]
    cost: float
    objective: Objective
    history: List[Tuple[int, float]]
    samples: int
    evaluations: int = 0
    population_log: List = field(default_factory=list)
    meta: Dict[str, Any] = field(default_factory=dict)
    spec: Optional[ExploreSpec] = None

    @property
    def n_subgraphs(self) -> int:
        return len(self.groups)

    @property
    def feasible(self) -> bool:
        return self.plan is not None and self.plan.feasible

    def summary(self) -> str:
        if self.plan is None:
            return (f"{self.workload}[{self.strategy}]: no plan "
                    f"(meta={self.meta})")
        bw = self.plan.avg_bandwidth() / 1e9
        return (
            f"{self.workload}[{self.strategy}]: {self.n_subgraphs} subgraphs | "
            f"cost={self.cost:.4g} | EMA={self.plan.ema_total/1e6:.2f} MB | "
            f"energy={self.plan.energy_pj/1e9:.3f} mJ | "
            f"avg BW={bw:.2f} GB/s | "
            f"GLB={self.acc.glb_bytes//1024}KB"
            + ("" if self.acc.shared else
               f" WBUF={self.acc.wbuf_bytes//1024}KB")
        )

    # -- serialization ----------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            "version": RESULT_VERSION,
            "workload": self.workload,
            "strategy": self.strategy,
            "groups": [sorted(s) for s in self.groups],
            "acc": acc_to_dict(self.acc),
            "plan": plan_to_dict(self.plan),
            # strict-JSON safe: math.inf (e.g. a budget-exceeded enum run)
            # serializes as null; from_dict maps it back
            "cost": self.cost if math.isfinite(self.cost) else None,
            "objective": objective_to_dict(self.objective),
            "history": [list(h) for h in self.history],
            "samples": self.samples,
            "evaluations": self.evaluations,
            "population_log": [[list(p) for p in gen]
                               for gen in self.population_log],
            "meta": self.meta,
            "spec": self.spec.to_dict() if self.spec is not None else None,
        }

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ExploreResult":
        return cls(
            workload=d["workload"],
            strategy=d["strategy"],
            groups=[set(s) for s in d["groups"]],
            acc=acc_from_dict(d["acc"]),
            plan=plan_from_dict(d.get("plan")),
            cost=d["cost"] if d["cost"] is not None else math.inf,
            objective=objective_from_dict(d["objective"]),
            history=[tuple(h) for h in d["history"]],
            samples=d["samples"],
            evaluations=d.get("evaluations", 0),
            population_log=[[tuple(p) for p in gen]
                            for gen in d.get("population_log", [])],
            meta=d.get("meta", {}),
            spec=(ExploreSpec.from_dict(d["spec"])
                  if d.get("spec") is not None else None),
        )

    @classmethod
    def from_json(cls, data: str) -> "ExploreResult":
        return cls.from_dict(json.loads(data))
