"""The share of its roofline that one of the port's kernel ops reached in
the traced batches: the least time its recorded calls could take (the
larger of operations over the dtype's peak and bytes over HBM's rate,
from each call's shapes) over the device time of the kernels launched
under the op, in %."""

from perfbench import counts


def work(op, call):
    if op == "repro_torch::flash_attention":
        q_shape, hkv, dv, causal, window, dtype = call
        return counts.attention_call(q_shape, hkv, dv, causal, window,
                                     dtype), dtype
    if op == "repro_torch::fused_swiglu":
        m, d, f, dtype = call
        return counts.swiglu_call(m, d, f, dtype), dtype
    if op == "repro_torch::fused_rmsnorm":
        m, d, dtype, sdtype = call
        return counts.rmsnorm_call(m, d, dtype, sdtype), dtype
    raise ValueError(op)


def share(run, op):
    if run.trace is None or not run.calls.get(op):
        return None
    device_s = run.trace.device_s_under(op)
    if not device_s:
        return None
    least = sum(counts.least_seconds(*work(op, c)) for c in run.calls[op])
    return least / device_s * 100
