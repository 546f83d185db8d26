"""Telemetry for the port: the ambient span/counter recorder.

The port's copy of ``repro.obs.recorder``.  Telemetry is side-channel only:
results are byte-identical whether a recorder is installed or not.
"""

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
