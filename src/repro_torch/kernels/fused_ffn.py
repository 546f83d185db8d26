"""Fused SwiGLU FFN (the port of the TPU kernel ``_ffn_kernel``).

:func:`fused_swiglu` launches the hand-written CUDA kernel in
``csrc/fused_ffn.cu``: a grid over (row tiles, d_ff tiles) whose blocks keep
their ``silu(x @ Wg) * (x @ Wi)`` tile on chip and write an fp32 partial of
the output, then a fixed-order sum of the partials.  It takes CUDA tensors
only.  :func:`swiglu_plain` is its plain torch version, on any device.
:func:`repro_torch.kernels.ops.swiglu` picks between them by the tensor's
device.
"""

from __future__ import annotations

import torch

from . import _build
from .ref import swiglu_ref

#: launches of the CUDA kernel in this process (added to once per launch
#: and nowhere else; callers may reset it to 0)
launches = 0


def swiglu_plain(x: torch.Tensor, wg: torch.Tensor, wi: torch.Tensor,
                 wo: torch.Tensor) -> torch.Tensor:
    """``(silu(x @ wg) * (x @ wi)) @ wo`` in fp32, cast back to ``x``'s
    dtype; on any device."""
    return swiglu_ref(x, wg, wi, wo)


def fused_swiglu(x: torch.Tensor, wg: torch.Tensor, wi: torch.Tensor,
                 wo: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel over ``x`` ``[M, d]``, ``wg``/``wi`` ``[d, f]`` and
    ``wo`` ``[f, d]``: contiguous, of one dtype (fp32 or bf16), on one CUDA
    device; any ``M``, ``d`` and ``f``.  Allocates the fp32 workspace of
    ``ceil(f / 128) * M * d`` floats.  Raises ``ValueError`` on other
    tensors and ``RuntimeError`` if the kernel cannot be built or
    launched."""
    global launches
    if x.dim() != 2:
        raise ValueError(f"fused_swiglu expects x [M, d], got {list(x.shape)}")
    m, d = x.shape
    f = wg.shape[-1] if wg.dim() == 2 else -1
    if wg.shape != (d, f) or wi.shape != (d, f) or wo.shape != (f, d):
        raise ValueError(
            f"fused_swiglu expects wg, wi [d, f] and wo [f, d] for d = {d}, "
            f"got {list(wg.shape)}, {list(wi.shape)}, {list(wo.shape)}")
    _build.check_cuda_tensors("fused_swiglu", x, wg, wi, wo)
    code = _build.dtype_code("fused_swiglu", x)
    if not wg.dtype == wi.dtype == wo.dtype == x.dtype:
        raise ValueError("fused_swiglu expects x and the weights in one dtype")
    out = torch.empty_like(x)
    if m == 0:
        return out
    lib = _build.load("fused_ffn")
    partial = torch.empty((lib.fused_ffn_splits(f), m, d),
                          dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.fused_ffn_launch(
            x.data_ptr(), wg.data_ptr(), wi.data_ptr(), wo.data_ptr(),
            out.data_ptr(), partial.data_ptr(), m, d, f, code,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"fused_ffn kernel launch failed: cudaError_t {err}")
    launches += 1
    return out
