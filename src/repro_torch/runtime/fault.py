"""Fault tolerance: heartbeats, straggler mitigation, restart policy (a
copy of the JAX package's ``repro.runtime.fault``, which imports no jax).

On a real cluster each host runs a :class:`HeartbeatMonitor` fed by the
training loop; the coordinator applies :class:`RestartPolicy` to decide
between (a) in-place retry, (b) checkpoint-restart on the same topology,
(c) elastic restart on the survivors (see elastic.py).  The logic is
topology-agnostic and fully unit-testable on CPU; only the transport (here:
in-process callables; on a pod: GRPC/coordination-service) is swappable.
"""

from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, Dict, List, Optional


class NodeState(str, Enum):
    HEALTHY = "healthy"
    SLOW = "slow"
    DEAD = "dead"


@dataclass
class FaultConfig:
    heartbeat_interval_s: float = 10.0
    dead_after_missed: int = 3
    straggler_factor: float = 2.0      # step time > factor * median => SLOW
    straggler_window: int = 20
    max_restarts_per_hour: int = 6


class HeartbeatMonitor:
    """Tracks per-node liveness + step-time distribution."""

    def __init__(self, cfg: FaultConfig, nodes: List[str],
                 clock: Callable[[], float] = time.monotonic):
        self.cfg = cfg
        self.clock = clock
        self.last_seen: Dict[str, float] = {n: clock() for n in nodes}
        self.step_times: Dict[str, List[float]] = {n: [] for n in nodes}

    def heartbeat(self, node: str, step_time_s: Optional[float] = None):
        self.last_seen[node] = self.clock()
        if step_time_s is not None:
            w = self.step_times.setdefault(node, [])
            w.append(step_time_s)
            del w[: -self.cfg.straggler_window]

    def state(self, node: str) -> NodeState:
        silence = self.clock() - self.last_seen[node]
        if silence > self.cfg.dead_after_missed * self.cfg.heartbeat_interval_s:
            return NodeState.DEAD
        times = self.step_times.get(node) or []
        other_medians = [statistics.median(v)
                         for n, v in self.step_times.items()
                         if n != node and v]
        if times and other_medians:
            med = statistics.median(other_medians)
            if med > 0 and statistics.median(times) > \
                    self.cfg.straggler_factor * med:
                return NodeState.SLOW
        return NodeState.HEALTHY

    def survey(self) -> Dict[str, NodeState]:
        return {n: self.state(n) for n in self.last_seen}

    def dead_nodes(self) -> List[str]:
        return [n for n, s in self.survey().items() if s == NodeState.DEAD]

    def stragglers(self) -> List[str]:
        return [n for n, s in self.survey().items() if s == NodeState.SLOW]


class Decision(str, Enum):
    CONTINUE = "continue"
    EXCLUDE_AND_RESTART = "exclude_and_restart"   # elastic: drop dead nodes
    RESTART_SAME = "restart_same"                 # transient failure
    HALT = "halt"                                 # restart budget exhausted


@dataclass
class RestartPolicy:
    cfg: FaultConfig
    restart_times: List[float] = field(default_factory=list)
    clock: Callable[[], float] = time.monotonic

    def _budget_ok(self) -> bool:
        now = self.clock()
        self.restart_times = [t for t in self.restart_times if now - t < 3600]
        return len(self.restart_times) < self.cfg.max_restarts_per_hour

    def decide(self, monitor: HeartbeatMonitor,
               step_failed: bool = False) -> Decision:
        dead = monitor.dead_nodes()
        if not dead and not step_failed:
            return Decision.CONTINUE
        if not self._budget_ok():
            return Decision.HALT
        self.restart_times.append(self.clock())
        if dead:
            return Decision.EXCLUDE_AND_RESTART
        return Decision.RESTART_SAME


def mitigate_stragglers(monitor: HeartbeatMonitor,
                        data_assignment: Dict[str, int]) -> Dict[str, int]:
    """Rebalance per-node microbatch counts away from stragglers (simple
    work-stealing: each straggler sheds one unit to the fastest node)."""
    out = dict(data_assignment)
    slow = monitor.stragglers()
    if not slow:
        return out
    healthy = [n for n, s in monitor.survey().items()
               if s == NodeState.HEALTHY]
    if not healthy:
        return out
    fastest = min(
        healthy,
        key=lambda n: (statistics.median(monitor.step_times[n])
                       if monitor.step_times.get(n) else float("inf")))
    for s in slow:
        if out.get(s, 0) > 1:
            out[s] -= 1
            out[fastest] = out.get(fastest, 0) + 1
    return out
