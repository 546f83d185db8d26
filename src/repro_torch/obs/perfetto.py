"""Chrome/Perfetto trace-event JSON exporters.

Two renderers onto the same target format (the Trace Event Format's JSON
object flavor, which https://ui.perfetto.dev opens directly):

* :func:`recorder_events` — a search run's span tree as nested "X"
  (complete) duration events on one track, with the recorder's timed
  samples (per-generation best/mean cost, population diversity) as "C"
  counter tracks.
* :func:`traffic_events` — a sim ``TrafficTrace`` timeline: steps as
  duration events on per-core tracks (prologue DRAM stream shards land on
  their owning core's track, compute steps on the whole-chip track) and
  DRAM/NoC bytes as counter tracks.  The time base converts simulated
  cycles to microseconds at the accelerator's clock, so the Perfetto
  ruler reads as real time on the modeled part.

Both return plain event dicts; :func:`chrome_trace_doc` wraps them in the
documented ``{"traceEvents": [...]}`` envelope.  Timestamps are
microseconds (the format's unit).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from .recorder import Recorder

__all__ = [
    "recorder_events",
    "traffic_events",
    "chrome_trace_doc",
    "write_chrome_trace",
]

TELEMETRY_FORMAT = "cocco-telemetry"
TELEMETRY_FORMAT_VERSION = 1

_SEARCH_PID = 1
_SIM_PID = 2


def _meta(pid: int, tid: Optional[int], name: str, label: str
          ) -> Dict[str, Any]:
    ev: Dict[str, Any] = {"ph": "M", "pid": pid, "name": name,
                          "args": {"name": label}, "ts": 0}
    if tid is not None:
        ev["tid"] = tid
    return ev


def recorder_events(rec: Recorder, pid: int = _SEARCH_PID
                    ) -> List[Dict[str, Any]]:
    """Render a :class:`Recorder` as trace events (spans + counters)."""
    events: List[Dict[str, Any]] = [
        _meta(pid, None, "process_name", "search"),
        _meta(pid, 1, "thread_name", "spans"),
    ]
    for sp in rec.spans:
        args = {k: v for k, v in sp.attrs.items()
                if isinstance(v, (int, float, str, bool))}
        events.append({
            "name": sp.name, "ph": "X", "pid": pid, "tid": 1,
            "ts": round(sp.t0_s * 1e6, 3),
            "dur": round(max(sp.dur_s, 0.0) * 1e6, 3),
            "args": args,
        })
    for name, t_s, value in rec.samples:
        events.append({
            "name": name, "ph": "C", "pid": pid, "tid": 1,
            "ts": round(t_s * 1e6, 3),
            "args": {"value": value},
        })
    return events


def traffic_events(trace: Any, pid: int = _SIM_PID,
                   max_counter_steps: int = 4096) -> List[Dict[str, Any]]:
    """Render a ``repro_torch.sim.trace.TrafficTrace`` as trace events.

    Per-core DRAM stream segments (``step.core >= 0``) get one track per
    core; whole-chip steps share track 0.  DRAM and NoC bytes become
    counter tracks sampled at each step start.  ``max_counter_steps``
    bounds counter-event volume on row-granular traces (duration events
    are always emitted one per step).
    """
    scale = 1e6 / trace.acc.freq_hz  # cycles -> microseconds
    events: List[Dict[str, Any]] = [
        _meta(pid, None, "process_name", f"sim:{trace.graph_name}"),
        _meta(pid, 0, "thread_name", "chip"),
    ]
    cores = sorted({s.core for s in trace.steps if s.core >= 0})
    for c in cores:
        events.append(_meta(pid, c + 1, "thread_name",
                            f"core{c} DRAM stream"))
    stride = max(1, len(trace.steps) // max_counter_steps)
    for i, stp in enumerate(trace.steps):
        name = ("prologue" if stp.subgraph < 0
                else f"sg{stp.subgraph}.step{stp.step}")
        tid = stp.core + 1 if stp.core >= 0 else 0
        events.append({
            "name": name, "ph": "X", "pid": pid, "tid": tid,
            "ts": round(stp.t_cycles * scale, 3),
            "dur": round(stp.cycles * scale, 3),
            "args": {"subgraph": stp.subgraph, "step": stp.step,
                     "rows": stp.rows, "macs": stp.macs},
        })
        if i % stride == 0:
            ts = round(stp.t_cycles * scale, 3)
            events.append({
                "name": "DRAM bytes", "ph": "C", "pid": pid, "tid": 0,
                "ts": ts,
                "args": {"in": stp.dram_in, "out": stp.dram_out},
            })
            events.append({
                "name": "NoC bytes", "ph": "C", "pid": pid, "tid": 0,
                "ts": ts, "args": {"broadcast": stp.noc_bytes},
            })
            events.append({
                "name": "occupancy", "ph": "C", "pid": pid, "tid": 0,
                "ts": ts, "args": {"act": stp.occ_act, "w": stp.occ_w},
            })
    return events


def chrome_trace_doc(events: List[Dict[str, Any]],
                     counters: Optional[Dict[str, float]] = None,
                     meta: Optional[Dict[str, Any]] = None
                     ) -> Dict[str, Any]:
    """Wrap events in the trace-event JSON object envelope.  Extra keys
    (``format``/``counters``/``meta``) are ignored by viewers but make the
    export self-describing for ``scripts/check_telemetry_schema.py``."""
    doc: Dict[str, Any] = {
        "format": TELEMETRY_FORMAT,
        "version": TELEMETRY_FORMAT_VERSION,
        "displayTimeUnit": "ms",
        "traceEvents": events,
    }
    if counters:
        doc["counters"] = dict(sorted(counters.items()))
    if meta:
        doc["meta"] = dict(meta)
    return doc


def write_chrome_trace(path: str, doc: Dict[str, Any]) -> None:
    import os

    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
