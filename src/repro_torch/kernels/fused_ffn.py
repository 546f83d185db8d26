"""SwiGLU FFN (the port of the TPU kernel ``_ffn_kernel``).

:func:`fused_swiglu` launches the hand-written CUDA kernels in
``csrc/fused_ffn.cu``: a dual GEMM that writes the hidden activation
``H = silu(x @ Wg) * (x @ Wi)`` in the compute dtype, then ``H @ Wo``, on
tiles chosen by the number of rows.  It takes CUDA tensors only.
:func:`swiglu_plain` is its plain torch version, split as the kernel is
split (:func:`swiglu_hidden_plain`, then the product with ``Wo``), on any
device.  :func:`repro_torch.kernels.ops.swiglu` picks between them by the
tensor's device.
"""

from __future__ import annotations

import torch

from . import _build

#: launches of the CUDA kernels in this process (added to once per call
#: that launches them and nowhere else; callers may reset it to 0)
launches = 0


def swiglu_hidden_plain(x: torch.Tensor, wg: torch.Tensor,
                        wi: torch.Tensor) -> torch.Tensor:
    """``silu(x @ wg) * (x @ wi)`` in fp32, cast to ``x``'s dtype (the
    hidden activation the first kernel writes); on any device."""
    xf = x.float()
    h = torch.nn.functional.silu(xf @ wg.float()) * (xf @ wi.float())
    return h.to(x.dtype)


def swiglu_plain_with_hidden(x: torch.Tensor, wg: torch.Tensor,
                             wi: torch.Tensor, wo: torch.Tensor):
    """:func:`swiglu_plain` and its hidden activation."""
    h = swiglu_hidden_plain(x, wg, wi)
    return (h.float() @ wo.float()).to(x.dtype), h


def swiglu_plain(x: torch.Tensor, wg: torch.Tensor, wi: torch.Tensor,
                 wo: torch.Tensor) -> torch.Tensor:
    """``(silu(x @ wg) * (x @ wi)) @ wo`` with the hidden activation held
    in ``x``'s dtype, as the kernels hold it, and fp32 products, cast back
    to ``x``'s dtype; on any device."""
    return swiglu_plain_with_hidden(x, wg, wi, wo)[0]


def fused_swiglu(x: torch.Tensor, wg: torch.Tensor, wi: torch.Tensor,
                 wo: torch.Tensor) -> torch.Tensor:
    """The CUDA kernels over ``x`` ``[M, d]``, ``wg``/``wi`` ``[d, f]`` and
    ``wo`` ``[f, d]``: contiguous, of one dtype (fp32 or bf16), on one CUDA
    device; any ``M``, ``d`` and ``f``.  Allocates the hidden activation
    ``[M, f]`` in that dtype.  Raises ``ValueError`` on other tensors and
    ``RuntimeError`` if the kernels cannot be built or launched."""
    return fused_swiglu_with_hidden(x, wg, wi, wo)[0]


def fused_swiglu_with_hidden(x: torch.Tensor, wg: torch.Tensor,
                             wi: torch.Tensor, wo: torch.Tensor):
    """:func:`fused_swiglu` and the hidden activation ``[M, f]`` its first
    kernel wrote (the backward's ``dWo = Hᵀ dY`` reads it)."""
    global launches
    if x.dim() != 2:
        raise ValueError(f"fused_swiglu expects x [M, d], got {list(x.shape)}")
    m, d = x.shape
    f = wg.shape[-1] if wg.dim() == 2 else -1
    if wg.shape != (d, f) or wi.shape != (d, f) or wo.shape != (f, d):
        raise ValueError(
            f"fused_swiglu expects wg, wi [d, f] and wo [f, d] for d = {d}, "
            f"got {list(wg.shape)}, {list(wi.shape)}, {list(wo.shape)}")
    index = _build.check_cuda_tensors("fused_swiglu", x, wg, wi, wo)
    code = _build.dtype_code("fused_swiglu", x)
    if not wg.dtype == wi.dtype == wo.dtype == x.dtype:
        raise ValueError("fused_swiglu expects x and the weights in one dtype")
    out = torch.empty_like(x)
    h = torch.empty((m, f), dtype=x.dtype, device=x.device)
    if m == 0:
        return out, h
    _build.launch(_build.load("fused_ffn").fused_ffn_launch, index,
                  x.data_ptr(), wg.data_ptr(), wi.data_ptr(), wo.data_ptr(),
                  h.data_ptr(), out.data_ptr(), m, d, f, code)
    launches += 1
    return out, h
