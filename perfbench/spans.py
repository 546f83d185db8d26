"""Reading the program's own spans in the traced batches' trace.

The port opens a ``torch.profiler`` range for each :mod:`repro_torch.obs`
span while the profiler records, so the spans are host events of the
kineto trace, on the device events' clock: ``serve.prefill`` and
``serve.decode_step`` around each forward (``serve/engine.py``),
``mla.expand`` / ``mla.attend``, ``moe.route`` / ``moe.experts`` /
``moe.combine`` and ``mamba.scan`` inside them (``models/layers.py``).
The spans are counted, and their idle time read, on the thread that
launched the most device work (every thread in a trace that launched
none); device time is ``Trace.device_s_under``'s, which ties each kernel
to the span around its launch on the launching thread.  Where the program
opens no such span, as before the spans were added, each reading is
None.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from perfbench.trace import Trace

#: the engine's spans, one a forward
FORWARD_SPANS = ("serve.prefill", "serve.decode_step")


def intervals(trace, *names: str) -> Dict[str, List[Tuple[float, float]]]:
    """The (start, end) µs of each event of the spans ``names``, in order,
    by name (one pass over the host events)."""
    main = trace.main_thread()
    out: Dict[str, List[Tuple[float, float]]] = {n: [] for n in names}
    for nm, _, thread, ts, dur, _ in trace.host:
        if nm in out and (main is None or thread == main):
            out[nm].append((ts, ts + dur))
    return {n: sorted(v) for n, v in out.items()}


def count(trace, *names: str) -> int:
    """How many events the spans ``names`` have in all."""
    return sum(len(v) for v in intervals(trace, *names).values())


def device_s(trace, *names: str) -> Optional[float]:
    """Device seconds of the kernels launched inside the spans ``names``
    (``Trace.device_s_under`` reads ``cpu_op`` events, the category kineto
    gives a profiler range); None where none of them ran."""
    under = [trace.device_s_under(n) for n in names]
    under = [s for s in under if s is not None]
    return sum(under) if under else None


def idle_s(trace, name: str) -> Optional[float]:
    """Seconds inside the spans ``name`` in which no device event ran: the
    union of the spans' intervals less the device's busy union; None where
    the span never ran."""
    # the spans' union, merged as the device's busy union is
    spans = Trace([(name, None, s, e - s, None)
                   for s, e in intervals(trace, name)[name]],
                  []).busy_intervals()
    if not spans:
        return None
    busy = trace.busy_intervals()
    covered, j = 0.0, 0
    for s, e in spans:
        while j < len(busy) and busy[j][1] <= s:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < e:
            covered += min(e, busy[k][1]) - max(s, busy[k][0])
            k += 1
    return (sum(e - s for s, e in spans) - covered) / 1e6


def per(run, seconds_of, base_spans=FORWARD_SPANS) -> Optional[float]:
    """``seconds_of(trace)`` in ms over the events of ``base_spans`` in the
    traced batches; None without a trace, a reading or such events."""
    n = count(run.trace, *base_spans) if run.trace is not None else 0
    value = seconds_of(run.trace) if n else None
    return None if value is None else value / n * 1e3

