"""B2, the port's attention kernel: q ``[B, H, S, dqk]``, k ``[B, Hkv, S,
dqk]``, v ``[B, Hkv, S, dv]`` (:func:`perfbench.counts.attention_call`)."""

from perfbench import counts
from perfbench.roofline import dtype

ATTR = "flash_attention_op"
OP = "repro_torch::flash_attention"


def record(q, k, v, causal, window, scale):
    return (tuple(q.shape), k.shape[1], v.shape[-1], bool(causal),
            int(window), dtype(q))


def work(call):
    q_shape, hkv, dv, causal, window, dt = call
    return counts.attention_call(q_shape, hkv, dv, causal, window, dt), dt
