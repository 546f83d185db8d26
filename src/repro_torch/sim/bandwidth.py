"""Bandwidth-requirement metrics derived from a traffic trace.

The paper's headline claims are byte counts *and* bandwidth requirements
(Fig. 3): a plan that moves the same bytes in shorter bursts needs a wider
DRAM interface.  From a step sequence this module derives

* ``peak``      — the largest per-step bandwidth (bytes/s),
* ``sustained`` — total bytes over total time,
* ``p50/p95/p99`` — time-weighted percentiles of per-step bandwidth, the
  statistic the ``bandwidth`` objective metric optimizes (the plan-level
  :meth:`~repro_torch.core.cost.PlanCost.bandwidth_percentile` is this profile
  computed at one-segment-per-subgraph resolution).

Percentiles share :func:`repro_torch.core.cost.time_weighted_percentile` with the
analytical layer so the two agree exactly at equal resolution.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Sequence, Tuple

from repro_torch.core.cost import time_weighted_percentile

DEFAULT_PERCENTILES: Tuple[float, ...] = (50.0, 95.0, 99.0)


@dataclass(frozen=True)
class BandwidthProfile:
    """Bandwidth requirement statistics of one trace (bytes/s)."""

    peak: float
    sustained: float
    percentiles: Dict[str, float]       # {"p50": ..., "p95": ..., "p99": ...}
    total_bytes: int
    total_cycles: float

    def to_dict(self) -> Dict[str, float]:
        d = {"peak": self.peak, "sustained": self.sustained,
             "total_bytes": self.total_bytes,
             "total_cycles": self.total_cycles}
        d.update(self.percentiles)
        return d


def profile_from_steps(
    steps: Iterable[Tuple[int, float]],
    freq_hz: float,
    percentiles: Sequence[float] = DEFAULT_PERCENTILES,
    totals: Optional[Tuple[int, float]] = None,
) -> BandwidthProfile:
    """Build a profile from ``(dram_bytes, duration_cycles)`` steps.

    ``steps`` feeds the *requirement* statistics (peak, percentiles);
    ``totals`` optionally overrides ``(total_bytes, total_cycles)`` to
    additionally count phases excluded from those statistics — the weight
    prologue streams at the DRAM link rate with nothing to overlap, so its
    bandwidth is the interface rate by definition and would floor every
    plan's peak at that constant if it entered the max.  Zero-duration
    steps carry no time weight and are likewise excluded from statistics
    (their bytes still count toward totals).
    """
    items = list(steps)
    if totals is None:
        totals = (sum(b for b, _ in items), sum(c for _, c in items))
    total_bytes, total_cycles = totals
    pairs = [(b / c * freq_hz, c) for b, c in items if c > 0]
    peak = max((bw for bw, _ in pairs), default=0.0)
    sustained = (total_bytes / total_cycles * freq_hz
                 if total_cycles > 0 else 0.0)
    pcts = {f"p{int(p) if float(p).is_integer() else p}":
            time_weighted_percentile(pairs, p) for p in percentiles}
    return BandwidthProfile(peak=peak, sustained=sustained,
                            percentiles=pcts, total_bytes=total_bytes,
                            total_cycles=total_cycles)
