"""Analytical <-> simulated cross-validation.

The trace simulator is a *lowering* of the analytical cost kernel, so for
every feasible plan the two must agree exactly:

* per subgraph, simulated DRAM bytes (external loads, output stores,
  weight first-load + re-streaming) equal the kernel's
  ``ema_in`` / ``ema_out`` / ``ema_w``,
* per subgraph, simulated NoC broadcast bytes equal the kernel's §5.4.2
  charge ``noc_bytes`` (and the step-level fabric traffic sums to the
  same total),
* the plan's simulated totals equal ``PlanCost.ema_total`` /
  ``PlanCost.noc_total`` byte-for-byte,
* the timeline's total duration equals ``PlanCost.latency_cycles`` plus
  the weight prologue (floating-point, checked to relative 1e-9).

Any drift means the simulator and the cost model disagree about what a
plan *does* — the golden workloads in ``tests/test_sim.py`` run this
check for every scheme's GA and greedy plans, which turns them into an
end-to-end oracle for the cost model.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Set

from repro_torch.core.cost import AcceleratorConfig, PlanCost
from repro_torch.core.graph import Graph

from .trace import TrafficTrace, simulate_plan


@dataclass(frozen=True)
class SubgraphCheck:
    """One subgraph's analytical-vs-simulated byte comparison."""

    index: int
    nodes: tuple
    ema_in_analytical: int
    ema_in_simulated: int
    ema_out_analytical: int
    ema_out_simulated: int
    ema_w_analytical: int
    ema_w_simulated: int
    noc_analytical: int = 0
    noc_simulated: int = 0

    @property
    def ok(self) -> bool:
        return (self.ema_in_analytical == self.ema_in_simulated
                and self.ema_out_analytical == self.ema_out_simulated
                and self.ema_w_analytical == self.ema_w_simulated
                and self.noc_analytical == self.noc_simulated)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "index": self.index, "nodes": list(self.nodes), "ok": self.ok,
            "analytical": {"in": self.ema_in_analytical,
                           "out": self.ema_out_analytical,
                           "w": self.ema_w_analytical,
                           "noc": self.noc_analytical},
            "simulated": {"in": self.ema_in_simulated,
                          "out": self.ema_out_simulated,
                          "w": self.ema_w_simulated,
                          "noc": self.noc_simulated},
        }


@dataclass
class CrossValidationReport:
    """Whole-plan verdict plus the per-subgraph evidence."""

    checks: List[SubgraphCheck]
    total_analytical: int
    total_simulated: int
    latency_analytical: float       # PlanCost.latency_cycles
    latency_simulated: float        # trace total minus the weight prologue
    noc_analytical: int = 0         # PlanCost.noc_total (§5.4.2 charge)
    noc_simulated: int = 0          # step-level fabric traffic sum

    @property
    def bytes_ok(self) -> bool:
        return (self.total_analytical == self.total_simulated
                and self.noc_analytical == self.noc_simulated
                and all(c.ok for c in self.checks))

    @property
    def latency_ok(self) -> bool:
        return math.isclose(self.latency_analytical, self.latency_simulated,
                            rel_tol=1e-9, abs_tol=1e-6)

    @property
    def ok(self) -> bool:
        return self.bytes_ok and self.latency_ok

    def to_dict(self) -> Dict[str, Any]:
        return {
            "ok": self.ok,
            "total_analytical_bytes": self.total_analytical,
            "total_simulated_bytes": self.total_simulated,
            "noc_analytical_bytes": self.noc_analytical,
            "noc_simulated_bytes": self.noc_simulated,
            "latency_analytical_cycles": self.latency_analytical,
            "latency_simulated_cycles": self.latency_simulated,
            "subgraphs": [c.to_dict() for c in self.checks],
        }

    def summary(self) -> str:
        if self.ok:
            noc = (f" + NoC {self.noc_simulated} B"
                   if self.noc_simulated else "")
            return (f"cross-validation OK: simulated DRAM bytes == "
                    f"analytical EMA ({self.total_simulated} B over "
                    f"{len(self.checks)} subgraphs{noc})")
        bad = [c.index for c in self.checks if not c.ok]
        return (f"cross-validation FAILED: simulated {self.total_simulated} "
                f"B vs analytical {self.total_analytical} B "
                f"(mismatched subgraphs: {bad or 'totals/latency only'})")

    def raise_if_failed(self) -> None:
        if not self.ok:
            raise AssertionError(self.summary())


def cross_validate_trace(trace: TrafficTrace,
                         plan: Optional[PlanCost] = None,
                         ) -> CrossValidationReport:
    """Compare an existing trace against its (or a caller's) plan cost."""
    plan = plan if plan is not None else trace.plan
    if plan is None:
        raise ValueError("cross-validation needs the analytical PlanCost")
    if len(plan.subgraphs) != len(trace.subgraphs):
        raise ValueError(
            f"plan has {len(plan.subgraphs)} subgraphs but the trace has "
            f"{len(trace.subgraphs)}")
    checks = [
        SubgraphCheck(
            index=i, nodes=tuple(sc.nodes),
            ema_in_analytical=sc.ema_in, ema_in_simulated=sg.act_in,
            ema_out_analytical=sc.ema_out, ema_out_simulated=sg.act_out,
            ema_w_analytical=sc.ema_w,
            ema_w_simulated=sg.w_first + sg.w_stream,
            noc_analytical=sc.noc_bytes,
            noc_simulated=sg.noc_bytes,
        )
        for i, (sc, sg) in enumerate(zip(plan.subgraphs, trace.subgraphs))
    ]
    prologue = sum(s.cycles for s in trace.steps if s.subgraph < 0)
    return CrossValidationReport(
        checks=checks,
        total_analytical=plan.ema_total,
        total_simulated=sum(sg.dram_bytes for sg in trace.subgraphs),
        latency_analytical=plan.latency_cycles,
        latency_simulated=trace.total_cycles - prologue,
        # step-level fabric traffic (incl. the prologue broadcast) must sum
        # to the same §5.4.2 charge the per-subgraph checks compare
        noc_analytical=plan.noc_total,
        noc_simulated=trace.total_noc_bytes,
    )


def cross_validate(
    g: Graph,
    groups: Sequence[Set[int]],
    acc: AcceleratorConfig,
    out_tile: int = 1,
) -> CrossValidationReport:
    """Simulate ``groups`` and compare against the analytical kernel."""
    trace = simulate_plan(g, groups, acc, out_tile=out_tile)
    return cross_validate_trace(trace)
