"""The share of the traced batches' wall time in which no operation ran on
the card (the union of the device's kernels, copies and sets taken as
busy), in %."""


def read(run):
    if run.trace is None or run.traced_s <= 0:
        return None
    return (1.0 - run.trace.busy_s() / run.traced_s) * 100
