"""Flash attention (the port of the TPU kernel ``_attn_kernel``).

:func:`flash_attention` launches the hand-written CUDA kernel in
``csrc/flash_attention.cu``: causal / sliding-window attention with an fp32
online softmax that reads grouped-query keys and values in place (query
head ``h`` uses kv head ``h // (H // Hkv)``) and takes any sequence length,
with v (and the output) as wide as q and k or, at MLA's widths, narrower
(:data:`WIDTH_PAIRS`).
It takes CUDA tensors only.  :func:`attention_plain` is its plain torch
version, on any device.  :func:`repro_torch.kernels.ops.attention` picks
between them by the tensor's device.

The kernel is also the torch op ``repro_torch::flash_attention``
(:data:`flash_attention_op`): its CUDA implementation is
:func:`flash_attention`, its fake implementation gives the output's
shape, dtype and device and computes nothing, so a fake ``cuda`` tensor
traces through it; it has no CPU implementation.  Its FLOP formula for
``torch.utils.flop_counter`` counts the products over the live pairs,
``2 · B · H · pairs · (dqk + dv)`` (:func:`live_pairs`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from torch.utils.flop_counter import register_flop_formula

from . import _build
from .ref import attention_ref

#: launches of the CUDA kernel in this process (added to once per launch
#: and nowhere else; callers may reset it to 0)
launches = 0

#: the head dims the CUDA kernel is built for with q, k and v of one width
HEAD_DIMS = (16, 32, 64, 128, 256)
#: the (q/k width, v width) pairs the CUDA kernel is built for
#: (``supports`` in ``csrc/flash_attention.cu``): one width
#: for all three, and MLA's at deepseek-v2's widths (128 + 64 rope
#: columns of q and k, 128 of v)
WIDTH_PAIRS = tuple((d, d) for d in HEAD_DIMS) + ((192, 128),)


def _check_shapes(name, q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 \
            or k.shape[:3] != v.shape[:3]:
        raise ValueError(f"{name} expects q [B, H, S, dqk], k [B, Hkv, S, "
                         f"dqk] and v [B, Hkv, S, dv], got {list(q.shape)}, "
                         f"{list(k.shape)}, {list(v.shape)}")
    B, H, S, d = q.shape
    Hkv = k.shape[1]
    if k.shape != (B, Hkv, S, d) or H % Hkv:
        raise ValueError(f"{name}: k, v {list(k.shape)}, {list(v.shape)} "
                         f"do not fit q {list(q.shape)} (H must be a "
                         f"multiple of Hkv)")


def _check_widths(name, q, v):
    pair = (q.shape[-1], v.shape[-1])
    if pair not in WIDTH_PAIRS:
        raise ValueError(f"{name} is built for the (q/k, v) widths "
                         f"{WIDTH_PAIRS}, not {pair}")


def _empty_out(q: torch.Tensor, dv: int) -> torch.Tensor:
    """An uninitialized ``[B, H, S, dv]`` output laid out as ``q`` is
    (``empty_like(q)`` at q's width): a transposed view of a ``[B, S, H,
    d]`` tensor gives one of a ``[B, S, H, dv]`` tensor."""
    if dv == q.shape[-1]:
        return torch.empty_like(q)
    outer = sorted(range(3), key=lambda i: (-q.stride(i), i))
    shape = [q.shape[i] for i in outer] + [dv]
    out = q.new_empty(shape)
    return out.permute(*[outer.index(i) for i in range(3)], 3)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """:func:`repro_torch.kernels.ref.attention_ref` with k, v of ``Hkv``
    heads repeated for the ``H / Hkv`` query heads of each group; v may be
    narrower than q and k (the output has v's width); on any device."""
    _check_shapes("attention_plain", q, k, v)
    g = q.shape[1] // k.shape[1]
    if g > 1:
        k = k.repeat_interleave(g, dim=1)
        v = v.repeat_interleave(g, dim=1)
    return attention_ref(q, k, v, causal=causal, window=window, scale=scale)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """The CUDA kernel over ``q`` ``[B, H, S, dqk]``, ``k`` ``[B, Hkv, S,
    dqk]`` and ``v`` ``[B, Hkv, S, dv]`` (any strides with the last dim
    contiguous; one dtype, fp32 or bf16; ``(dqk, dv)`` in
    :data:`WIDTH_PAIRS`) on one CUDA device.  The output is ``[B, H, S,
    dv]``, laid out as ``q`` is: a transposed view of a ``[B, S, H, d]``
    tensor comes back as one.  Raises ``ValueError`` on other tensors and
    widths and ``RuntimeError`` if the kernel cannot be built or
    launched."""
    global launches
    _check_shapes("flash_attention", q, k, v)
    _check_widths("flash_attention", q, v)
    index = _build.check_cuda_tensors("flash_attention", q, k, v,
                                      contiguous=False)
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention expects the last dim of q, k, v "
                         "to be contiguous")
    code = _build.dtype_code("flash_attention", q)
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError("flash_attention expects q, k, v in one dtype")
    B, H, S, d = q.shape
    dv = v.shape[-1]
    out = _empty_out(q, dv)
    if B == 0 or S == 0:
        return out
    lib = _build.load("flash_attention")
    scale = scale or 1.0 / math.sqrt(d)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    _build.launch(lib.flash_attention_launch, index, q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H,
                  k.shape[1], S, d, dv, *strides, int(causal), int(window),
                  scale, code)
    launches += 1
    return out


def live_pairs(s_len: int, causal: bool = True, window: int = 0) -> int:
    """The (query, key) pairs of one head that the masks leave live over
    ``s_len`` positions: key ``j`` for query ``i`` where ``j <= i`` if
    ``causal`` and ``j > i - window`` if ``window``."""
    n, w = s_len, window
    if not causal:
        return n * n if not w or n < w else n * n - (n - w) * (n - w + 1) // 2
    if not w or n <= w:
        return n * (n + 1) // 2
    return w * (w + 1) // 2 + (n - w) * w


_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("flash_attention(Tensor q, Tensor k, Tensor v, bool causal, "
            "int window, float? scale) -> Tensor")
_LIB.impl("flash_attention", flash_attention, "CUDA")


@torch.library.register_fake("repro_torch::flash_attention", lib=_LIB)
def _flash_attention_fake(q, k, v, causal, window, scale):
    _check_shapes("flash_attention", q, k, v)
    _check_widths("flash_attention", q, v)
    return _empty_out(q, v.shape[-1])


#: the kernel as a torch op: ``flash_attention_op(q, k, v, causal, window,
#: scale)``, every argument positional
flash_attention_op = torch.ops.repro_torch.flash_attention.default


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_attention_flops(q_shape, k_shape, v_shape, causal, window,
                           scale, *args, out_shape=None, **kwargs) -> int:
    B, H, S, dqk = q_shape
    return 2 * B * H * live_pairs(S, causal, window) * (dqk + v_shape[-1])
