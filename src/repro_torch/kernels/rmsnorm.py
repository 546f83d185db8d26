"""Fused RMSNorm (the port of the TPU kernel ``_rms_kernel``).

:func:`fused_rmsnorm` launches the hand-written CUDA kernel in
``csrc/rmsnorm.cu`` (one pass: each row is held in registers between its
sum of squares and its output; fp32 statistics); it takes CUDA tensors
only.  :func:`rmsnorm_plain` is its plain torch version, on any device.
:func:`repro_torch.kernels.ops.rmsnorm` picks between them by the tensor's
device.

The kernel is also the torch op ``repro_torch::fused_rmsnorm``
(:data:`fused_rmsnorm_op`): its CUDA implementation is
:func:`fused_rmsnorm`, its fake implementation gives the output's shape,
dtype and device and computes nothing; it has no CPU implementation.
Its FLOP formula counts ``4 · M · d`` (a square and a sum for the
statistics, two products for the output).
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

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


def _check_shapes(x, scale) -> tuple:
    """(M, d) of x ``[M, d]`` and scale ``[d]``; raises ``ValueError``
    otherwise."""
    shape, s_shape = x.shape, scale.shape
    if len(shape) != 2 or len(s_shape) != 1 or s_shape[0] != shape[1]:
        raise ValueError(f"fused_rmsnorm expects x [M, d] and scale [d], got "
                         f"{list(shape)} and {list(s_shape)}")
    return tuple(shape)


def fused_rmsnorm(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """The CUDA kernel over ``x`` ``[M, d]`` (contiguous) and ``scale``
    ``[d]``, each fp32 or bf16, on one CUDA device; any ``M``.  Raises
    ``ValueError`` on other tensors and ``RuntimeError`` if the kernel
    cannot be built or launched."""
    global launches
    m, d = _check_shapes(x, scale)
    index = _build.check_cuda_tensors("fused_rmsnorm", x, scale)
    x_code = _build.dtype_code("fused_rmsnorm", x)
    s_code = _build.dtype_code("fused_rmsnorm", scale)
    out = torch.empty_like(x)
    if m == 0:
        return out
    x_ptr, s_ptr, o_ptr = x.data_ptr(), scale.data_ptr(), out.data_ptr()
    vec = vector_route(x_ptr, s_ptr, o_ptr, d, x.element_size())
    _build.launch(_build.load("rmsnorm").rmsnorm_launch, index, x_ptr, s_ptr,
                  o_ptr, m, d, eps, x_code, s_code, vec)
    launches += 1
    return out


_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("fused_rmsnorm(Tensor x, Tensor scale, float eps) -> Tensor")
_LIB.impl("fused_rmsnorm", fused_rmsnorm, "CUDA")


@torch.library.register_fake("repro_torch::fused_rmsnorm", lib=_LIB)
def _fused_rmsnorm_fake(x, scale, eps):
    _check_shapes(x, scale)
    return torch.empty_like(x)


#: the kernel as a torch op: ``fused_rmsnorm_op(x, scale, eps)``
fused_rmsnorm_op = torch.ops.repro_torch.fused_rmsnorm.default


@register_flop_formula(torch.ops.repro_torch.fused_rmsnorm)
def _fused_rmsnorm_flops(x_shape, *args, out_shape=None, **kwargs) -> int:
    m, d = x_shape
    return 4 * m * d
