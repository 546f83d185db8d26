"""The 95th percentile, over every request the window served, of its
batch's time to the first tokens on the host (the engine's ``ttft_s``:
cache allocation, the prefill forward and the first tokens read back),
nearest rank."""

import math


def read(run):
    ttft = sorted(b["ttft_s"] for b in run.batches for _ in b["tokens"])
    if not ttft:
        return None
    return ttft[math.ceil(0.95 * len(ttft)) - 1] * 1e3
