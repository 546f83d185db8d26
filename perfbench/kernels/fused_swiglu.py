"""B3, the port's SwiGLU kernel: x ``[M, d]``, wg and wi ``[d, f]``, wo
``[f, d]`` (:func:`perfbench.counts.swiglu_call`)."""

from perfbench import counts
from perfbench.roofline import dtype

ATTR = "fused_swiglu_op"
OP = "repro_torch::fused_swiglu"


def record(x, wg, wi, wo):
    return (x.shape[0], x.shape[1], wg.shape[1], dtype(x))


def work(call):
    m, d, f, dt = call
    return counts.swiglu_call(m, d, f, dt), dt
