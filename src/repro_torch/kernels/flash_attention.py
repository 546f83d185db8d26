"""Flash attention (the port of the TPU kernel ``_attn_kernel``).

:func:`flash_attention` launches the hand-written CUDA kernel in
``csrc/flash_attention.cu``: causal / sliding-window attention with an fp32
online softmax that reads grouped-query keys and values in place (query
head ``h`` uses kv head ``h // (H // Hkv)``) and takes any sequence length.
It takes CUDA tensors only.  :func:`attention_plain` is its plain torch
version, on any device.  :func:`repro_torch.kernels.ops.attention` picks
between them by the tensor's device.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build
from .ref import attention_ref

#: launches of the CUDA kernel in this process (added to once per launch
#: and nowhere else; callers may reset it to 0)
launches = 0

#: the head dims the CUDA kernel is built for
#: (``flash_attention_supports`` in ``csrc/flash_attention.cu``)
HEAD_DIMS = (16, 32, 64, 128, 256)


def _check_shapes(name, q, k, v):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name} expects q [B, H, S, d] and k, v "
                         f"[B, Hkv, S, d], got {list(q.shape)}, "
                         f"{list(k.shape)}, {list(v.shape)}")
    B, H, S, d = q.shape
    Hkv = k.shape[1]
    if k.shape != (B, Hkv, S, d) or H % Hkv:
        raise ValueError(f"{name}: k, v {list(k.shape)} do not fit q "
                         f"{list(q.shape)} (H must be a multiple of Hkv)")


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """:func:`repro_torch.kernels.ref.attention_ref` with k, v of ``Hkv``
    heads repeated for the ``H / Hkv`` query heads of each group; on any
    device."""
    _check_shapes("attention_plain", q, k, v)
    g = q.shape[1] // k.shape[1]
    if g > 1:
        k = k.repeat_interleave(g, dim=1)
        v = v.repeat_interleave(g, dim=1)
    return attention_ref(q, k, v, causal=causal, window=window, scale=scale)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """The CUDA kernel over ``q`` ``[B, H, S, d]`` and ``k``, ``v``
    ``[B, Hkv, S, d]`` (any strides with the last dim contiguous; one dtype,
    fp32 or bf16; ``d`` in 16, 32, 64, 128, 256) on one CUDA device.  The
    output has ``q``'s shape and, where ``q`` is dense, its strides: a
    transposed view of a ``[B, S, H, d]`` tensor comes back as one.  Raises
    ``ValueError`` on other tensors and ``RuntimeError`` if the kernel
    cannot be built or launched."""
    global launches
    _check_shapes("flash_attention", q, k, v)
    index = _build.check_cuda_tensors("flash_attention", q, k, v,
                                      contiguous=False)
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention expects the last dim of q, k, v "
                         "to be contiguous")
    code = _build.dtype_code("flash_attention", q)
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError("flash_attention expects q, k, v in one dtype")
    B, H, S, d = q.shape
    out = torch.empty_like(q)
    if B == 0 or S == 0:
        return out
    lib = _build.load("flash_attention")
    if not lib.flash_attention_supports(d):
        raise ValueError(f"flash_attention is built for head dims "
                         f"{HEAD_DIMS}, not {d}")
    scale = scale or 1.0 / math.sqrt(d)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    _build.launch(lib.flash_attention_launch, index, q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H,
                  k.shape[1], S, d, *strides, int(causal), int(window),
                  scale, code)
    launches += 1
    return out
