"""Telemetry for the port: spans + counters + exporters, the port's copy of
``repro.obs`` (docs/observability.md).

One substrate for every layer's runtime visibility:

* :mod:`repro_torch.obs.recorder` — the ambient :class:`Recorder` (nested
  spans, counters, timed samples) with a near-zero disabled path; while
  ``torch.profiler`` records, every span is also a profiler range of its
  name, so the serving path's spans (``serve.prefill``,
  ``serve.decode_step``, ``mla.*``, ``moe.*``, ``mamba.scan``) land in the
  profiler's trace (docs/serving_spans_torch.md).
* :mod:`repro_torch.obs.perfetto` — Chrome/Perfetto trace-event JSON export of
  a recorder or a sim ``TrafficTrace``.
* :mod:`repro_torch.obs.metrics` — Prometheus-style histograms and the text
  exposition the plan server's ``/metrics`` endpoint serves.

The hard invariant: telemetry is side-channel only.  Results and stored
artifacts are byte-identical whether a recorder is installed or not.
"""

from .metrics import DEFAULT_LATENCY_BUCKETS, Histogram, render_metrics
from .perfetto import (
    TELEMETRY_FORMAT,
    TELEMETRY_FORMAT_VERSION,
    chrome_trace_doc,
    recorder_events,
    traffic_events,
    write_chrome_trace,
)
from .recorder import (
    NullRecorder,
    Recorder,
    Span,
    add,
    current,
    enabled,
    recording,
    sample,
    span,
)

__all__ = [
    "DEFAULT_LATENCY_BUCKETS",
    "Histogram",
    "render_metrics",
    "TELEMETRY_FORMAT",
    "TELEMETRY_FORMAT_VERSION",
    "chrome_trace_doc",
    "recorder_events",
    "traffic_events",
    "write_chrome_trace",
    "NullRecorder",
    "Recorder",
    "Span",
    "add",
    "current",
    "enabled",
    "recording",
    "sample",
    "span",
]
