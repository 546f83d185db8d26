"""SwiGLU FFN (the port of the TPU kernel ``_ffn_kernel``).

:func:`fused_swiglu` launches the hand-written CUDA kernels in
``csrc/fused_ffn.cu``: a dual GEMM that writes the hidden activation
``H = silu(x @ Wg) * (x @ Wi)`` in the compute dtype, then ``H @ Wo``, on
tiles chosen by the number of rows.  It takes CUDA tensors only.
:func:`swiglu_plain` is its plain torch version, split as the kernel is
split (:func:`swiglu_hidden_plain`, then the product with ``Wo``), on any
device.  :func:`repro_torch.kernels.ops.swiglu` picks between them by the
tensor's device.

The kernels are also the torch ops ``repro_torch::fused_swiglu`` and
``repro_torch::fused_swiglu_with_hidden`` (:data:`fused_swiglu_op`,
:data:`fused_swiglu_with_hidden_op`): their CUDA implementations are
:func:`fused_swiglu` and :func:`fused_swiglu_with_hidden`, their fake
implementations give the outputs' shapes, dtype and device and compute
nothing; they have no CPU implementation.  Their FLOP formula counts
the three products, ``6 · M · d · f``.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

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


def _check_shapes(x, wg, wi, wo) -> tuple:
    """(M, d, f) of a SwiGLU's operands; raises ``ValueError`` if they do
    not fit together."""
    if x.dim() != 2:
        raise ValueError(f"fused_swiglu expects x [M, d], got {list(x.shape)}")
    m, d = x.shape
    f = wg.shape[-1] if wg.dim() == 2 else -1
    if wg.shape != (d, f) or wi.shape != (d, f) or wo.shape != (f, d):
        raise ValueError(
            f"fused_swiglu expects wg, wi [d, f] and wo [f, d] for d = {d}, "
            f"got {list(wg.shape)}, {list(wi.shape)}, {list(wo.shape)}")
    return m, d, f


def fused_swiglu(x: torch.Tensor, wg: torch.Tensor, wi: torch.Tensor,
                 wo: torch.Tensor) -> torch.Tensor:
    """The CUDA kernels over ``x`` ``[M, d]``, ``wg``/``wi`` ``[d, f]`` and
    ``wo`` ``[f, d]``: contiguous, of one dtype (fp32 or bf16), on one CUDA
    device; any ``M``, ``d`` and ``f``.  Allocates the hidden activation
    ``[M, f]`` in that dtype, and in fp32 the workspace of the products
    the kernels split along K (``fused_ffn_workspace``).  Raises
    ``ValueError`` on other tensors and ``RuntimeError`` if the kernels
    cannot be built or launched."""
    return fused_swiglu_with_hidden(x, wg, wi, wo)[0]


def fused_swiglu_with_hidden(x: torch.Tensor, wg: torch.Tensor,
                             wi: torch.Tensor, wo: torch.Tensor):
    """:func:`fused_swiglu` and the hidden activation ``[M, f]`` its first
    kernel wrote (the backward's ``dWo = Hᵀ dY`` reads it)."""
    global launches
    m, d, f = _check_shapes(x, wg, wi, wo)
    index = _build.check_cuda_tensors("fused_swiglu", x, wg, wi, wo)
    code = _build.dtype_code("fused_swiglu", x)
    if not wg.dtype == wi.dtype == wo.dtype == x.dtype:
        raise ValueError("fused_swiglu expects x and the weights in one dtype")
    out = torch.empty_like(x)
    h = torch.empty((m, f), dtype=x.dtype, device=x.device)
    if m == 0:
        return out, h
    lib = _build.load("fused_ffn")
    ws_bytes = _workspace_bytes(lib, index, m, d, f, code)
    ws = (torch.empty(ws_bytes, dtype=torch.uint8, device=x.device)
          if ws_bytes else None)
    _build.launch(lib.fused_ffn_launch, index, x.data_ptr(), wg.data_ptr(),
                  wi.data_ptr(), wo.data_ptr(), h.data_ptr(), out.data_ptr(),
                  ws.data_ptr() if ws is not None else None, ws_bytes, m, d,
                  f, code)
    launches += 1
    return out, h


# workspace bytes by (device, m, d, f, dtype code): the fp32 route's split
# partial sums, planned from the device's SM count and the kernels'
# occupancy, which do not change within a process
_WORKSPACE: dict = {}


def _workspace_bytes(lib, index: int, m: int, d: int, f: int,
                     code: int) -> int:
    key = (index, m, d, f, code)
    n = _WORKSPACE.get(key)
    if n is None:
        n = _build.query(lib.fused_ffn_workspace, index, m, d, f, code)
        if n < 0:
            raise RuntimeError(f"fused_ffn_workspace failed: cudaError_t "
                               f"{-n}")
        _WORKSPACE[key] = n
    return n


_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("fused_swiglu(Tensor x, Tensor wg, Tensor wi, Tensor wo) "
            "-> Tensor")
_LIB.define("fused_swiglu_with_hidden(Tensor x, Tensor wg, Tensor wi, "
            "Tensor wo) -> (Tensor, Tensor)")
_LIB.impl("fused_swiglu", fused_swiglu, "CUDA")
_LIB.impl("fused_swiglu_with_hidden", fused_swiglu_with_hidden, "CUDA")


@torch.library.register_fake("repro_torch::fused_swiglu", lib=_LIB)
def _fused_swiglu_fake(x, wg, wi, wo):
    _check_shapes(x, wg, wi, wo)
    return torch.empty_like(x)


@torch.library.register_fake("repro_torch::fused_swiglu_with_hidden",
                             lib=_LIB)
def _fused_swiglu_with_hidden_fake(x, wg, wi, wo):
    m, _, f = _check_shapes(x, wg, wi, wo)
    return torch.empty_like(x), x.new_empty((m, f))


#: the kernels as torch ops, called as ``fused_swiglu_op(x, wg, wi, wo)``
fused_swiglu_op = torch.ops.repro_torch.fused_swiglu.default
fused_swiglu_with_hidden_op = \
    torch.ops.repro_torch.fused_swiglu_with_hidden.default


@register_flop_formula([torch.ops.repro_torch.fused_swiglu,
                        torch.ops.repro_torch.fused_swiglu_with_hidden])
def _fused_swiglu_flops(x_shape, wg_shape, *args, out_shape=None,
                        **kwargs) -> int:
    m, d = x_shape
    return 6 * m * d * wg_shape[1]
