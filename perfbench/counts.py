"""The benchmark's own yardstick of work: the operations and bytes of one
call of each of the port's kernels, computed from the call's shapes, and
the model FLOPs of a forward, computed from a configuration file and the
terms of the mechanisms its ``layers`` name (``reference/<name>.py``).

Kept here, frozen, so that a change to the program cannot move the
yardstick it is measured by.  The peaks are NVIDIA's data sheet figures
for one H100 SXM (dense, no sparsity).
"""

from __future__ import annotations

from typing import Dict, Sequence

from perfbench import spec

#: dense tensor-core rate of bf16 and fp16, operations a second
PEAK_BF16_FLOPS = 989.4e12
#: float32 outside the tensor cores, operations a second
PEAK_FP32_FLOPS = 67e12
#: HBM3, bytes a second
PEAK_HBM_BYTES = 3.35e12

PEAK_FLOPS = {"bfloat16": PEAK_BF16_FLOPS, "float16": PEAK_BF16_FLOPS,
              "float32": PEAK_FP32_FLOPS}
ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def live_pairs(s_len: int, causal: bool = True, window: int = 0) -> int:
    """(query, key) pairs of one head that the masks leave live over
    ``s_len`` positions: key j for query i where j <= i if ``causal``, and
    j > i - window if ``window``."""
    n, w = s_len, window
    if not causal:
        return n * n if not w or n < w else n * n - (n - w) * (n - w + 1) // 2
    if not w or n <= w:
        return n * (n + 1) // 2
    return w * (w + 1) // 2 + (n - w) * w


def attention_call(q_shape: Sequence[int], hkv: int, dv: int, causal: bool,
                   window: int, dtype: str) -> Dict[str, float]:
    """B2 over q ``[B, H, S, dqk]``, k ``[B, Hkv, S, dqk]``, v ``[B, Hkv,
    S, dv]``: ``2 B H pairs (dqk + dv)`` operations; q, k and v read once
    and the output ``[B, H, S, dv]`` written once."""
    B, H, S, dqk = q_shape
    flops = 2 * B * H * live_pairs(S, causal, window) * (dqk + dv)
    elems = B * H * S * dqk + B * hkv * S * (dqk + dv) + B * H * S * dv
    return {"flops": flops, "bytes": elems * ITEMSIZE[dtype]}


def swiglu_call(m: int, d: int, f: int, dtype: str) -> Dict[str, float]:
    """B3 over x ``[M, d]``, wg and wi ``[d, f]``, wo ``[f, d]``: three
    products, ``6 M d f`` operations; x and the weights read once and the
    output ``[M, d]`` written once (the hidden activation is the kernels'
    own intermediate)."""
    return {"flops": 6 * m * d * f,
            "bytes": (2 * m * d + 3 * d * f) * ITEMSIZE[dtype]}


def rmsnorm_call(m: int, d: int, dtype: str,
                 scale_dtype: str) -> Dict[str, float]:
    """B4 over x ``[M, d]`` and scale ``[d]``: ``4 M d`` operations; x and
    the scale read once, the output written once."""
    return {"flops": 4 * m * d,
            "bytes": 2 * m * d * ITEMSIZE[dtype] + d * ITEMSIZE[scale_dtype]}


def mla_decode_call(b: int, h: int, kvr: int, r: int, live: int,
                    dtype: str) -> Dict[str, float]:
    """MLA's latent decode over q_lat ``[B, H, kvr]``, q_rope ``[B, H,
    r]`` and ``live`` cache slots in all (each row's slots up to its
    position) of ``kvr + r`` columns: ``2 H live (2 kvr + r)`` operations
    (scores over ``kvr + r`` columns, the weights over the ``kvr`` values);
    the live slots, q and the output ``[B, H, kvr]`` moved once."""
    return {"flops": 2 * h * live * (2 * kvr + r),
            "bytes": (live * (kvr + r) + b * h * (2 * kvr + r))
            * ITEMSIZE[dtype]}


def least_seconds(work: Dict[str, float], dtype: str) -> float:
    """The least time the chip could take for ``work``: the larger of its
    operations over the dtype's peak and its bytes over HBM's rate."""
    return max(work["flops"] / PEAK_FLOPS[dtype],
               work["bytes"] / PEAK_HBM_BYTES)


# -- model FLOPs ---------------------------------------------------------

def forward_flops(c: dict, batch: int, new: int, past: int,
                  head_rows: int) -> int:
    """Model FLOPs of one forward of ``batch`` sequences over ``new``
    tokens each at positions ``past .. past + new - 1`` (a prefill has
    ``past`` 0, a decode step ``new`` 1), with the head on ``head_rows``
    rows of each sequence: for each mechanism of each layer
    (:func:`perfbench.spec.mechanism`), 2 a weight a token, its operations
    a live causal pair and its operations a token outside the
    products."""
    tokens = batch * new
    pairs = batch * (live_pairs(past + new) - live_pairs(past))
    total = 0
    for names in c["layers"]:
        for m in map(spec.mechanism, names):
            total += 2 * tokens * m.params(c)
            if hasattr(m, "pair_flops"):
                total += pairs * m.pair_flops(c)
            if hasattr(m, "token_flops"):
                total += tokens * m.token_flops(c)
    total += 2 * batch * head_rows * c["hidden_size"] * c["vocab_size"]
    return total


def batch_flops(c: dict, batch: int, prompt_len: int,
                decode_steps: int) -> Dict[str, int]:
    """Model FLOPs of one served batch: the prefill over the prompts (the
    head on the last row only, as the engine reads it) and each decode
    step over one token."""
    prefill = forward_flops(c, batch, prompt_len, 0, 1)
    decode = sum(forward_flops(c, batch, 1, prompt_len + t, 1)
                 for t in range(decode_steps))
    return {"prefill": prefill, "decode": decode}
