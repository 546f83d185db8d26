"""Fused RMSNorm (the port of the TPU kernel ``_rms_kernel``).

:func:`fused_rmsnorm` launches the hand-written CUDA kernel in
``csrc/rmsnorm.cu`` (one pass: each row is held in registers between its
sum of squares and its output; fp32 statistics); it takes CUDA tensors
only.  :func:`rmsnorm_plain` is its plain torch version, on any device.
:func:`repro_torch.kernels.ops.rmsnorm` picks between them by the tensor's
device.
"""

from __future__ import annotations

import torch

from . import _build
from .ref import rmsnorm_ref

#: launches of the CUDA kernel in this process (added to once per launch
#: and nowhere else; callers may reset it to 0)
launches = 0


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """``x * rsqrt(mean(x**2) + eps) * scale`` over the rows of ``[M, d]``
    in fp32, cast back to ``x``'s dtype; on any device."""
    return rmsnorm_ref(x, scale, eps)


def vector_route(x_ptr: int, scale_ptr: int, out_ptr: int, d: int,
                 itemsize: int) -> bool:
    """Whether the kernel may move rows in 16-byte units: x, scale and out
    start on 16-byte boundaries and a row of ``d`` elements of ``itemsize``
    bytes is a whole number of 16-byte units.  Otherwise it moves single
    elements.  (A contiguous view with a storage offset, as
    ``x.reshape(-1, d).contiguous()`` may hand over, can start off a
    16-byte boundary.)"""
    return (x_ptr | scale_ptr | out_ptr) % 16 == 0 and d * itemsize % 16 == 0


def fused_rmsnorm(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """The CUDA kernel over ``x`` ``[M, d]`` (contiguous) and ``scale``
    ``[d]``, each fp32 or bf16, on one CUDA device; any ``M``.  Raises
    ``ValueError`` on other tensors and ``RuntimeError`` if the kernel
    cannot be built or launched."""
    global launches
    shape, s_shape = x.shape, scale.shape
    if len(shape) != 2 or len(s_shape) != 1 or s_shape[0] != shape[1]:
        raise ValueError(f"fused_rmsnorm expects x [M, d] and scale [d], got "
                         f"{list(shape)} and {list(s_shape)}")
    index = _build.check_cuda_tensors("fused_rmsnorm", x, scale)
    x_code = _build.dtype_code("fused_rmsnorm", x)
    s_code = _build.dtype_code("fused_rmsnorm", scale)
    m, d = shape
    out = torch.empty_like(x)
    if m == 0:
        return out
    x_ptr, s_ptr, o_ptr = x.data_ptr(), scale.data_ptr(), out.data_ptr()
    vec = vector_route(x_ptr, s_ptr, o_ptr, d, x.element_size())
    _build.launch(_build.load("rmsnorm").rmsnorm_launch, index, x_ptr, s_ptr,
                  o_ptr, m, d, eps, x_code, s_code, vec)
    launches += 1
    return out
