"""MLA's latent decode: q_lat ``[B, H, kvr]``, q_rope ``[B, H, r]`` over
the cache ckv ``[B, T, kvr]`` and k_rope ``[B, T, r]``, each row ``b``
live to slot ``positions[b]`` (:func:`perfbench.counts.mla_decode_call`:
each row's live slots, q and the output, as ``chip_smoke.py`` bounds the
kernel)."""

from perfbench import counts
from perfbench.roofline import dtype

ATTR = "mla_decode_op"
OP = "repro_torch::mla_decode"


def record(q_lat, q_rope, ckv, k_rope, positions, scale):
    # the positions tensor itself, read once the trace is over: reading
    # it here would wait for the device.  The engine makes it anew each
    # decode step and nothing writes it after.
    b, h, kvr = q_lat.shape
    return (b, h, kvr, q_rope.shape[-1], ckv.shape[1], dtype(q_lat),
            positions)


def work(call):
    b, h, kvr, r, slots, dt, positions = call
    live = int((positions + 1).clamp(0, slots).sum())
    return counts.mla_decode_call(b, h, kvr, r, live, dt), dt
