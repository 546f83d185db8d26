"""Prometheus-style metric primitives and text exposition (format 0.0.4).

Zero-dependency building blocks for the plan server's ``/metrics``
endpoint.  :class:`Histogram` replaces the old ``_LatencyWindow``: where
the window silently dropped samples past its 512-entry deque and served
quantiles over whatever happened to remain, the histogram is cumulative
over the process lifetime — every observation lands in a bucket, and
exact ``count`` / ``sum`` / ``max`` ride alongside so the back-compat
``/stats`` view keeps its mean and max exact (quantiles become the usual
Prometheus bucket interpolation).
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

__all__ = ["DEFAULT_LATENCY_BUCKETS", "Histogram", "render_metrics"]

# Latency bucket upper bounds in *seconds*, spanning sub-millisecond
# zoo hits through multi-second cold searches.  +Inf is implicit.
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)


class Histogram:
    """Cumulative histogram with exact count/sum/max side-channels."""

    __slots__ = ("bounds", "bucket_counts", "count", "total", "max")

    def __init__(self, buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS
                 ) -> None:
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self.bounds = bounds
        # per-bucket (non-cumulative) counts; index len(bounds) == +Inf
        self.bucket_counts = [0] * (len(bounds) + 1)
        self.count = 0
        self.total = 0.0
        self.max = 0.0

    def observe(self, value: float) -> None:
        value = float(value)
        self.count += 1
        self.total += value
        if value > self.max:
            self.max = value
        for i, bound in enumerate(self.bounds):
            if value <= bound:
                self.bucket_counts[i] += 1
                return
        self.bucket_counts[-1] += 1

    def cumulative(self) -> List[Tuple[float, int]]:
        """``[(le, cumulative_count), ...]`` ending with (+Inf, count)."""
        out: List[Tuple[float, int]] = []
        running = 0
        for bound, n in zip(self.bounds, self.bucket_counts):
            running += n
            out.append((bound, running))
        out.append((math.inf, self.count))
        return out

    def quantile(self, q: float) -> float:
        """Prometheus-style bucket-interpolated quantile estimate."""
        if self.count == 0:
            return 0.0
        rank = q * self.count
        running = 0
        lo = 0.0
        for bound, n in zip(self.bounds, self.bucket_counts):
            if n and running + n >= rank:
                frac = (rank - running) / n
                return lo + (bound - lo) * frac
            running += n
            lo = bound
        # rank falls in the +Inf bucket: best estimate is the exact max
        return self.max

    def snapshot_ms(self) -> Dict[str, float]:
        """Back-compat ``/stats`` view (same keys as the old window)."""
        mean = self.total / self.count if self.count else 0.0
        return {
            "count": self.count,
            "mean_ms": round(mean * 1e3, 3),
            "max_ms": round(self.max * 1e3, 3),
            "p50_ms": round(self.quantile(0.50) * 1e3, 3),
            "p95_ms": round(self.quantile(0.95) * 1e3, 3),
        }


def _fmt_value(v: float) -> str:
    if isinstance(v, float) and math.isinf(v):
        return "+Inf"
    if isinstance(v, float) and v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v) if isinstance(v, float) else str(v)


def _fmt_labels(labels: Optional[Mapping[str, str]]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        '%s="%s"' % (k, str(v).replace("\\", "\\\\").replace('"', '\\"'))
        for k, v in sorted(labels.items()))
    return "{%s}" % inner


def render_metrics(families: Iterable[Tuple[str, str, str, List[Tuple[
        Optional[Mapping[str, str]], object]]]]) -> str:
    """Render metric families as Prometheus text exposition 0.0.4.

    Each family is ``(name, type, help, samples)`` where ``type`` is one
    of ``counter`` / ``gauge`` / ``histogram``.  For scalar families each
    sample is ``(labels_or_None, number)``; for histograms each sample is
    ``(labels_or_None, Histogram)`` and expands into the conventional
    ``_bucket{le=...}`` / ``_sum`` / ``_count`` series.
    """
    lines: List[str] = []
    for name, mtype, help_text, samples in families:
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {mtype}")
        for labels, value in samples:
            if mtype == "histogram":
                assert isinstance(value, Histogram)
                base = dict(labels or {})
                for le, cum in value.cumulative():
                    blabels = dict(base)
                    blabels["le"] = _fmt_value(le)
                    lines.append(f"{name}_bucket{_fmt_labels(blabels)} {cum}")
                lines.append(
                    f"{name}_sum{_fmt_labels(base)} "
                    f"{_fmt_value(value.total)}")
                lines.append(
                    f"{name}_count{_fmt_labels(base)} {value.count}")
            else:
                lines.append(
                    f"{name}{_fmt_labels(labels)} {_fmt_value(value)}")
    return "\n".join(lines) + "\n"
