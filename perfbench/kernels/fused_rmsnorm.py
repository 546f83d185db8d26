"""B4, the port's RMSNorm kernel: x ``[M, d]`` and scale ``[d]``
(:func:`perfbench.counts.rmsnorm_call`)."""

from perfbench import counts
from perfbench.roofline import dtype

ATTR = "fused_rmsnorm_op"
OP = "repro_torch::fused_rmsnorm"


def record(x, scale, eps):
    return (x.shape[0], x.shape[1], dtype(x), dtype(scale))


def work(call):
    m, d, dt, sdt = call
    return counts.rmsnorm_call(m, d, dt, sdt), dt
