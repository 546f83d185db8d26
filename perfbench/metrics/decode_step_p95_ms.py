"""The 95th percentile, nearest rank, of every decode step's host time in
the window: the engine's ``step_s`` (from one step's tokens on the host to
the next's), in ms.  None where the engine keeps no ``step_s``.

A host time and a tail: it follows the host's speed and its stalls, so
read it only in interleaved pairs (parent, change, change, parent) within
one call on the card, never across calls."""

import math


def read(run):
    steps = sorted(s for b in run.batches for s in b.get("step_s", ()))
    if not steps:
        return None
    return steps[math.ceil(0.95 * len(steps)) - 1] * 1e3
