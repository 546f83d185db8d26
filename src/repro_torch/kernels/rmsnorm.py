"""Fused RMSNorm (the port of the TPU kernel ``_rms_kernel``).

:func:`fused_rmsnorm` launches the hand-written CUDA kernel in
``csrc/rmsnorm.cu`` (one block a row, fp32 statistics); it takes CUDA
tensors only.  :func:`rmsnorm_plain` is its plain torch version, on any
device.  :func:`repro_torch.kernels.ops.rmsnorm` picks between them by the
tensor's device.
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


def fused_rmsnorm(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """The CUDA kernel over ``x`` ``[M, d]`` (contiguous) and ``scale``
    ``[d]``, each fp32 or bf16, on one CUDA device; any ``M``.  Raises
    ``ValueError`` on other tensors and ``RuntimeError`` if the kernel
    cannot be built or launched."""
    global launches
    if x.dim() != 2 or scale.shape != (x.shape[1],):
        raise ValueError(f"fused_rmsnorm expects x [M, d] and scale [d], got "
                         f"{list(x.shape)} and {list(scale.shape)}")
    _build.check_cuda_tensors("fused_rmsnorm", x, scale)
    x_code = _build.dtype_code("fused_rmsnorm", x)
    s_code = _build.dtype_code("fused_rmsnorm", scale)
    out = torch.empty_like(x)
    if x.shape[0] == 0:
        return out
    lib = _build.load("rmsnorm")
    with torch.cuda.device(x.device):
        err = lib.rmsnorm_launch(x.data_ptr(), scale.data_ptr(),
                                 out.data_ptr(), x.shape[0], x.shape[1],
                                 eps, x_code, s_code,
                                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed: cudaError_t {err}")
    launches += 1
    return out
