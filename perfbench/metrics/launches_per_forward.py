"""Device kernels in the traced batches over the forwards run there (one
prefill and its decode steps a batch): the launch path's count, which
repeats exactly."""


def read(run):
    if run.trace is None or not run.traced_batches:
        return None
    forwards = sum(1 + b["decode_steps"] for b in run.traced_batches)
    return len(run.trace.kernels()) / forwards
