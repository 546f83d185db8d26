"""Structured telemetry recorder: nested spans, counters, timed samples.

The recorder is the single substrate every layer emits into: the search
front door (``resolve-workload`` / ``strategy:<name>`` spans), the GA loop
(per-generation spans plus best/mean/diversity samples), the batched
engine (``evaluate_batch`` / executor submit+join spans, scalar-fallback
counters), the partition repair loop, the structure-memo tiers, and the
LM serving path (``serve.*``, ``mla.*``, ``moe.*`` and ``mamba.scan``
spans, docs/serving_spans_torch.md).

A span has two sinks.  An installed :class:`Recorder` keeps it in its tree;
while ``torch.profiler`` records on the calling thread, the span is also a
profiler range of the same name (kineto exports it as a ``cpu_op`` event),
so it lands in the profiler's trace on the device events' clock.  torch is
looked at only where it is already imported: the planner's imports stay
torch-free.

Design constraints (the hard invariant carried from PRs 7-9):

* **Side-channel only.**  Nothing here ever touches an ``ExploreResult``
  or a stored artifact; exporters write to a *separate* file.
* **Near-zero when disabled.**  The ambient recorder defaults to a
  shared :class:`NullRecorder` whose ``add``/``sample`` are empty method
  calls and whose ``span()``, with the profiler off too, hands back one
  reusable no-op context manager — no clock reads, no allocation: a
  ``ContextVar`` lookup and one check of the profiler's state.
* **Ambient, not threaded through signatures.**  A ``ContextVar`` holds
  the active recorder (the same pattern ``strategies._ACTIVE_STORE``
  uses), so deep call sites (``CachedEvaluator``, ``split_to_fit_batch``)
  emit without plumbing a recorder argument through every layer.
"""

from __future__ import annotations

import sys
import time
from contextlib import contextmanager
from contextvars import ContextVar
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple

__all__ = [
    "Span",
    "Recorder",
    "NullRecorder",
    "current",
    "enabled",
    "recording",
    "span",
    "add",
    "sample",
]


@dataclass
class Span:
    """One timed region.  ``parent`` indexes into ``Recorder.spans``
    (-1 for roots); ``t0_s``/``dur_s`` are seconds relative to the
    recorder's epoch on the monotonic clock."""

    index: int
    parent: int
    name: str
    t0_s: float
    dur_s: float = 0.0
    attrs: Dict[str, Any] = field(default_factory=dict)


class _NullSpan:
    """Shared, stateless no-op context manager."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False


_NULL_SPAN = _NullSpan()


def _profiler_range(name: str) -> Any:
    """A ``torch.profiler`` range named ``name``, not yet entered, while
    the profiler records on this thread; else None.  torch is not imported
    here: where nothing has imported it, nothing can be profiling."""
    torch = sys.modules.get("torch")
    if torch is None or not torch._C._autograd._profiler_enabled():
        return None
    return torch._C._profiler._RecordFunctionFast(name)


class NullRecorder:
    """Disabled recorder: every operation is a constant-time no-op, but for
    ``span()`` while torch's profiler records, which is a profiler range."""

    enabled = False

    __slots__ = ()

    def span(self, name: str, **attrs: Any) -> Any:
        rng = _profiler_range(name)
        return _NULL_SPAN if rng is None else rng

    def add(self, name: str, value: float = 1) -> None:
        pass

    def sample(self, name: str, value: float) -> None:
        pass

    def merge_counters(self, mapping: Dict[str, Any],
                       prefix: str = "") -> None:
        pass


class _SpanCtx:
    """Context manager for one live span on a real :class:`Recorder` (and a
    profiler range around it while the profiler records)."""

    __slots__ = ("_rec", "_name", "_attrs", "_span", "_range")

    def __init__(self, rec: "Recorder", name: str,
                 attrs: Dict[str, Any]) -> None:
        self._rec = rec
        self._name = name
        self._attrs = attrs
        self._span: Optional[Span] = None
        self._range: Any = None

    def __enter__(self) -> Span:
        self._range = _profiler_range(self._name)
        if self._range is not None:
            self._range.__enter__()
        self._span = self._rec._open(self._name, self._attrs)
        return self._span

    def __exit__(self, *exc: Any) -> bool:
        assert self._span is not None
        self._rec._close(self._span)
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


class Recorder:
    """Collects spans, counters, and timestamped samples for one run.

    Spans are appended in *entry* order (a pre-order walk of the tree),
    so ``spans[i].parent < i`` always holds and exporters can render the
    tree in a single pass.  A recorder is single-threaded by design: the
    ambient ``ContextVar`` keeps concurrent server searches isolated.
    """

    enabled = True

    def __init__(self) -> None:
        self._epoch = time.perf_counter()
        self.spans: List[Span] = []
        self.counters: Dict[str, float] = {}
        # (series name, t_s relative to epoch, value)
        self.samples: List[Tuple[str, float, float]] = []
        self._stack: List[int] = []

    # -- span lifecycle -------------------------------------------------
    def span(self, name: str, **attrs: Any) -> _SpanCtx:
        return _SpanCtx(self, name, attrs)

    def _open(self, name: str, attrs: Dict[str, Any]) -> Span:
        parent = self._stack[-1] if self._stack else -1
        sp = Span(index=len(self.spans), parent=parent, name=name,
                  t0_s=time.perf_counter() - self._epoch, attrs=attrs)
        self.spans.append(sp)
        self._stack.append(sp.index)
        return sp

    def _close(self, sp: Span) -> None:
        sp.dur_s = time.perf_counter() - self._epoch - sp.t0_s
        # tolerate exceptions unwinding through several spans at once
        while self._stack and self._stack[-1] >= sp.index:
            self._stack.pop()

    # -- counters and samples -------------------------------------------
    def add(self, name: str, value: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + value

    def sample(self, name: str, value: float) -> None:
        self.samples.append(
            (name, time.perf_counter() - self._epoch, float(value)))

    def merge_counters(self, mapping: Dict[str, Any],
                       prefix: str = "") -> None:
        """Fold a flat dict of numeric counters (e.g. the evaluator's
        ``counters()`` output) into this recorder, skipping non-numeric
        entries."""
        for key, val in mapping.items():
            if isinstance(val, bool) or not isinstance(val, (int, float)):
                continue
            self.add(prefix + key, val)

    # -- views ----------------------------------------------------------
    def span_tree(self) -> List[Dict[str, Any]]:
        """Nested ``{"name": ..., "children": [...]}`` view, for tests
        that pin tree *shape* without depending on timings."""
        nodes: List[Dict[str, Any]] = [
            {"name": sp.name, "children": []} for sp in self.spans]
        roots: List[Dict[str, Any]] = []
        for sp, node in zip(self.spans, nodes):
            if sp.parent < 0:
                roots.append(node)
            else:
                nodes[sp.parent]["children"].append(node)
        return roots

    def to_dict(self) -> Dict[str, Any]:
        return {
            "spans": [
                {"index": sp.index, "parent": sp.parent, "name": sp.name,
                 "t0_s": sp.t0_s, "dur_s": sp.dur_s, "attrs": sp.attrs}
                for sp in self.spans],
            "counters": dict(self.counters),
            "samples": [
                {"name": n, "t_s": t, "value": v}
                for n, t, v in self.samples],
        }


_NULL = NullRecorder()
_ACTIVE: ContextVar[Any] = ContextVar("repro_obs_recorder", default=_NULL)


def current() -> Any:
    """The ambient recorder (a :class:`NullRecorder` when disabled)."""
    return _ACTIVE.get()


def enabled() -> bool:
    return _ACTIVE.get().enabled


@contextmanager
def recording(rec: Recorder) -> Iterator[Recorder]:
    """Install *rec* as the ambient recorder for the enclosed block."""
    token = _ACTIVE.set(rec)
    try:
        yield rec
    finally:
        _ACTIVE.reset(token)


def span(name: str, **attrs: Any) -> Any:
    """Open a span on the ambient recorder, and a profiler range while
    torch's profiler records (a shared no-op with neither)."""
    rec = _ACTIVE.get()
    # forwarding an empty ``**attrs`` costs as much as the rest of the call
    return rec.span(name, **attrs) if attrs else rec.span(name)


def add(name: str, value: float = 1) -> None:
    _ACTIVE.get().add(name, value)


def sample(name: str, value: float) -> None:
    _ACTIVE.get().sample(name, value)
