"""The benchmark's own yardstick of work: the operations and bytes of one
call of each of the port's kernels, computed from the call's shapes, and
the model FLOPs of a forward, computed from a configuration file.

Kept here, frozen, so that a change to the program cannot move the
yardstick it is measured by.  The peaks are NVIDIA's data sheet figures
for one H100 SXM (dense, no sparsity).
"""

from __future__ import annotations

from typing import Dict, Sequence

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


def least_seconds(work: Dict[str, float], dtype: str) -> float:
    """The least time the chip could take for ``work``: the larger of its
    operations over the dtype's peak and its bytes over HBM's rate."""
    return max(work["flops"] / PEAK_FLOPS[dtype],
               work["bytes"] / PEAK_HBM_BYTES)


# -- model FLOPs ---------------------------------------------------------

def _mixer_params(c: dict, mixer: str) -> int:
    """Weights of the projections of one mixer, from the configuration's
    published keys."""
    d = c["hidden_size"]
    h = c["num_attention_heads"]
    if mixer == "mla":
        dn, r, dv = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                     c["v_head_dim"])
        qr, kvr = c["q_lora_rank"], c["kv_lora_rank"]
        q = d * qr + qr * h * (dn + r) if qr else d * h * (dn + r)
        return q + d * (kvr + r) + kvr * h * (dn + dv) + h * dv * d
    if mixer == "gqa":
        dh = d // h
        kh = c["num_key_value_heads"]
        return d * h * dh + 2 * d * kh * dh + h * dh * d
    if mixer == "mamba":
        di = c["mamba_expand"] * d
        n, dtr = c["mamba_d_state"], c["mamba_dt_rank"]
        return d * 2 * di + di * (dtr + 2 * n) + dtr * di + di * d
    raise ValueError(mixer)


def _ffn_params(c: dict, ffn: str) -> int:
    """Weights one token passes through in one FFN: the dense SwiGLU, or
    the router, its ``top-k`` routed experts and the shared ones (not the
    program's capacity slots)."""
    d = c["hidden_size"]
    if ffn == "dense":
        return 3 * d * c["intermediate_size"]
    if ffn == "moe":
        e = c.get("n_routed_experts") or c["num_experts"]
        f = c.get("moe_intermediate_size") or c["intermediate_size"]
        k = c["num_experts_per_tok"] + c.get("n_shared_experts", 0)
        return d * e + k * 3 * d * f
    raise ValueError(ffn)


def _mixer_pair_flops(c: dict, mixer: str) -> int:
    """Operations of attention a live (query, key) pair: ``2 H (dqk +
    dv)``; 0 for a mixer that attends to nothing."""
    h = c["num_attention_heads"]
    if mixer == "mla":
        return 2 * h * (c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
                        + c["v_head_dim"])
    if mixer == "gqa":
        return 2 * h * 2 * (c["hidden_size"] // h)
    return 0


def _mixer_token_flops(c: dict, mixer: str) -> int:
    """Operations a token outside the products: Mamba's depthwise conv
    (``2 K di``) and its scan (``6 di n``: the input term, the update and
    the read-out, a multiply and an add each)."""
    if mixer != "mamba":
        return 0
    di = c["mamba_expand"] * c["hidden_size"]
    return 2 * c["mamba_d_conv"] * di + 6 * di * c["mamba_d_state"]


def forward_flops(c: dict, batch: int, new: int, past: int,
                  head_rows: int) -> int:
    """Model FLOPs of one forward of ``batch`` sequences over ``new``
    tokens each at positions ``past .. past + new - 1`` (a prefill has
    ``past`` 0, a decode step ``new`` 1), with the head on ``head_rows``
    rows of each sequence: 2 a weight a token, attention's live causal
    pairs, Mamba's conv and scan."""
    tokens = batch * new
    pairs = batch * (live_pairs(past + new) - live_pairs(past))
    total = 0
    for mixer, ffn in c["layers"]:
        total += 2 * tokens * (_mixer_params(c, mixer) + _ffn_params(c, ffn))
        total += pairs * _mixer_pair_flops(c, mixer)
        total += tokens * _mixer_token_flops(c, mixer)
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
