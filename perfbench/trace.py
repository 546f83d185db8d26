"""Reading a ``torch.profiler`` trace of the card: the device's events, the
host's, which of the port's kernel ops launched each device kernel, the
device's busy time, and the breakdown of where the time went.

The events are read from the chrome trace that kineto writes itself,
without the Python post-processing of ``prof.events()`` (tens of
microseconds of host time an event).
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

#: kineto's categories of the device's events and of the host's
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")
#: host events that launch work on the device
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class Trace:
    """The events of one traced stretch.

    ``device``: (name, category, start µs, duration µs, correlation);
    ``host``: (name, category, thread, start µs, duration µs,
    correlation)."""

    def __init__(self, device: List[tuple], host: List[tuple]):
        self.device = device
        self.host = host

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        device, host = [], []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat")
            corr = (e.get("args") or {}).get("correlation")
            if cat in DEVICE_CATS:
                device.append((e["name"], cat, float(e["ts"]),
                               float(e["dur"]), corr))
            elif cat in HOST_CATS:
                host.append((e["name"], cat, (e.get("pid"), e.get("tid")),
                             float(e["ts"]), float(e["dur"]), corr))
        return cls(device, host)

    def kernels(self) -> List[tuple]:
        return [e for e in self.device if e[1] == "kernel"]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device events' intervals (µs), in order: an
        overlap counts once."""
        out: List[Tuple[float, float]] = []
        for start, end in sorted((ts, ts + dur)
                                 for _, _, ts, dur, _ in self.device):
            if out and start <= out[-1][1]:
                if end > out[-1][1]:
                    out[-1] = (out[-1][0], end)
            else:
                out.append((start, end))
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def main_thread(self):
        """The host thread that launched the most device work."""
        n = collections.Counter(t for _, cat, t, _, _, _ in self.host
                                if cat in LAUNCH_CATS)
        return n.most_common(1)[0][0] if n else None

    def device_s_under(self, op: str) -> Optional[float]:
        """Device seconds of the kernels launched while a host op named
        ``op`` ran on the launching thread (its interval encloses the
        launch); None where no such op ran."""
        spans = collections.defaultdict(list)
        for name, cat, thread, ts, dur, _ in self.host:
            if cat == "cpu_op" and name == op:
                spans[thread].append((ts, ts + dur))
        if not spans:
            return None
        starts = {t: [s for s, _ in sorted(v)] for t, v in spans.items()}
        ends = {t: [e for _, e in sorted(v)] for t, v in spans.items()}
        corrs = set()
        for _, cat, thread, ts, _, corr in self.host:
            if cat not in LAUNCH_CATS or thread not in spans:
                continue
            i = bisect.bisect_right(starts[thread], ts) - 1
            if i >= 0 and ts <= ends[thread][i]:
                corrs.add(corr)
        return sum(dur for _, cat, _, dur, corr in self.device
                   if cat == "kernel" and corr in corrs) / 1e6

    def top_device_ops(self, n: int = 10) -> List[list]:
        """The device operations with the most time: [name, seconds]."""
        total = collections.Counter()
        for name, _, _, dur, _ in self.device:
            total[name[:120]] += dur / 1e6
        return [[k, v] for k, v in total.most_common(n)]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The device's idle time between its busy intervals, by what the
        main host thread was doing at each gap's middle (its innermost
        event there, or "host Python" where none): [name, seconds], the
        largest first."""
        thread = self.main_thread()
        evs = sorted((ts, ts + dur, name) for name, _, t, ts, dur, _
                     in self.host if t == thread)
        starts = [s for s, _, _ in evs]
        by = collections.Counter()
        busy = self.busy_intervals()
        for (_, a), (b, _) in zip(busy, busy[1:]):
            mid = (a + b) / 2
            i = bisect.bisect_right(starts, mid)
            name = "host Python"
            # the innermost event that covers mid: the latest-starting one
            for s, e, nm in reversed(evs[max(0, i - 64):i]):
                if e >= mid:
                    name = nm[:120]
                    break
            by[name] += (b - a) / 1e6
        return [[k, v] for k, v in by.most_common(n)]
