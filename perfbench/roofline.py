"""The share of its roofline that one of the port's kernel ops reached in
the traced batches: the least time its recorded calls could take (the
larger of operations over the dtype's peak and bytes over HBM's rate,
from each call's shapes, by the op's file: :func:`perfbench.spec.kernel_op`)
over the device time of the kernels launched under the op, in %."""

from perfbench import counts, spec


def dtype(t) -> str:
    """A tensor's dtype by the name :mod:`perfbench.counts` keys on."""
    return str(t.dtype).removeprefix("torch.")


def work(op, call):
    """(operations and bytes, dtype) of one recorded call of ``op``."""
    return spec.kernel_op(op).work(call)


def share(run, op):
    if run.trace is None or not run.calls.get(op):
        return None
    device_s = run.trace.device_s_under(op)
    if not device_s:
        return None
    least = sum(counts.least_seconds(*work(op, c)) for c in run.calls[op])
    return least / device_s * 100
