"""B2, B3 and B4 under autograd: one ``torch.autograd.Function`` a kernel.

The forward is the kernel's torch op on a CUDA tensor (real or fake) and
its plain torch version on a CPU tensor, as
:mod:`repro_torch.kernels.ops` dispatches; the backward is
an explicit gradient formula in torch ops, the same on both devices (the
JAX package has no backward kernel; it takes its gradients from plain
jnp).  ``ops`` sends a call here only while grad is enabled and an input
requires grad; otherwise it calls the kernel directly.

* attention (FA-2's formulas): ``P`` recomputed in fp32 from q and k with
  the causal and window masks, then ``dV = Pᵀ dO``, ``dS = P ⊙ (dO Vᵀ −
  rowsum(dO ⊙ O))``, ``dQ = scale · dS K``, ``dK = scale · dSᵀ Q``; under
  GQA, ``dK`` and ``dV`` summed over the query heads of each kv head.  All
  in fp32.
* SwiGLU: the forward keeps the hidden activation ``H = silu(g) ⊙ u`` the
  first kernel writes, for ``dWo = Hᵀ dY``; ``g = x Wg`` and ``u = x Wi``
  are recomputed.  Products and elementwise terms in fp32 (bf16 operands
  through fp32-output tensor-core products); ``dH`` rounded to ``H``'s
  dtype, as autograd rounds a bf16 tensor's gradient.
* RMSNorm: ``dx = r · (dŷ − x̂ · mean(dŷ ⊙ x̂))`` with ``dŷ = dy ⊙ scale``,
  ``dscale = Σ_rows dy ⊙ x̂``, in fp32.

Each gradient is cast to its input's dtype.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import flash_attention as _fa
from . import fused_ffn as _ff
from . import rmsnorm as _rn


def _gqa_sum(t: torch.Tensor, hkv: int) -> torch.Tensor:
    """``[B, H, S, d]`` summed over the ``H / hkv`` query heads of each kv
    head (query head ``h`` reads kv head ``h // (H / hkv)``)."""
    B, H, S, d = t.shape
    if H == hkv:
        return t
    return t.view(B, hkv, H // hkv, S, d).sum(dim=2)


def attention_backward(q, k, v, o, do, causal: bool = True, window: int = 0,
                       scale: Optional[float] = None):
    """(dq, dk, dv) of attention over q ``[B, H, S, dqk]``, k ``[B, Hkv,
    S, dqk]`` and v ``[B, Hkv, S, dv]`` (``dv`` may differ from ``dqk``)
    whose output ``[B, H, S, dv]`` was ``o``, for the output gradient
    ``do``; fp32 math, each cast to its input's dtype."""
    H, S, d = q.shape[1], q.shape[2], q.shape[3]
    hkv = k.shape[1]
    scale = scale or 1.0 / math.sqrt(d)
    g = H // hkv
    qf, of, dof = q.float(), o.float(), do.float()
    kf = k.float().repeat_interleave(g, dim=1) if g > 1 else k.float()
    vf = v.float().repeat_interleave(g, dim=1) if g > 1 else v.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    qi = torch.arange(S, device=q.device)[:, None]
    ki = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window:
        mask &= ki > qi - window
    p = torch.softmax(s.masked_fill_(~mask, float("-inf")), dim=-1)
    p = torch.nan_to_num_(p, nan=0.0)  # rows with no live key
    dv = torch.matmul(p.transpose(-1, -2), dof)
    delta = (dof * of).sum(dim=-1, keepdim=True)
    ds = p.mul_(torch.matmul(dof, vf.transpose(-1, -2)).sub_(delta))
    dq = torch.matmul(ds, kf).mul_(scale)
    dk = torch.matmul(ds.transpose(-1, -2), qf).mul_(scale)
    return (dq.to(q.dtype), _gqa_sum(dk, hkv).to(k.dtype),
            _gqa_sum(dv, hkv).to(v.dtype))


def _mm32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in fp32, as the plain version computes it: bf16 operands
    on the card through cuBLAS's bf16 product with an fp32 output (exact
    products, fp32 sums, on the tensor cores); an fp32 operand against a
    bf16 one split into two bf16 terms (``hi + lo``: 16 bits of
    mantissa), two such products summed; otherwise both in fp32."""
    if a.is_cuda and torch.bfloat16 in (a.dtype, b.dtype):
        if a.dtype == b.dtype:
            return torch.mm(a, b, out_dtype=torch.float32)
        if a.dtype == torch.float32:
            hi = a.to(b.dtype)
            return _mm32(hi, b).add_(_mm32((a - hi.float()).to(b.dtype), b))
        hi = b.to(a.dtype)
        return _mm32(a, hi).add_(_mm32(a, (b - hi.float()).to(a.dtype)))
    return a.float() @ b.float()


def swiglu_backward(x, wg, wi, wo, h, dy):
    """(dx, dwg, dwi, dwo) of ``(silu(x Wg) ⊙ x Wi) Wo`` given its hidden
    activation ``h`` (in ``x``'s dtype, as the kernel holds it) and the
    output gradient ``dy``; fp32 products (:func:`_mm32`) and
    elementwise terms, as autograd through the plain version computes
    them: the hidden activation's gradient is rounded to its dtype, as
    autograd rounds the gradient of a bf16 tensor."""
    dy = dy.to(x.dtype)
    dwo = _mm32(h.t(), dy)
    dh = _mm32(dy, wo.t()).to(h.dtype).float()
    gf = _mm32(x, wg)
    uf = _mm32(x, wi)
    sg = torch.sigmoid(gf)
    du = dh * gf * sg
    dg = dh.mul_(uf).mul_(sg).mul_(gf.mul_(1.0 - sg).add_(1.0))
    dx = _mm32(dg, wg.t()).add_(_mm32(du, wi.t()))
    return (dx.to(x.dtype), _mm32(x.t(), dg).to(wg.dtype),
            _mm32(x.t(), du).to(wi.dtype), dwo.to(wo.dtype))


def rmsnorm_backward(x, scale, dy, eps: float = 1e-5):
    """(dx, dscale) of ``x · rsqrt(mean(x²) + eps) · scale`` over the rows
    of ``x`` ``[M, d]``."""
    xf = x.float()
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    xhat = xf * r
    dyf = dy.float()
    dyhat = dyf * scale.float()
    dx = r * (dyhat - xhat * (dyhat * xhat).mean(dim=-1, keepdim=True))
    dscale = (dyf * xhat).sum(dim=0)
    return dx.to(x.dtype), dscale.to(scale.dtype)


class Attention(torch.autograd.Function):
    """B2 (or its plain version on the CPU) with FA-2's backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        if q.is_cuda:
            o = _fa.flash_attention_op(q, k, v, causal, window, scale)
        else:
            o = _fa.attention_plain(q, k, v, causal=causal, window=window,
                                    scale=scale)
        ctx.save_for_backward(q, k, v, o)
        ctx.args = (causal, window, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        return (*attention_backward(q, k, v, o, do, *ctx.args),
                None, None, None)


class SwiGLU(torch.autograd.Function):
    """B3 (or its plain version on the CPU), keeping its hidden
    activation for the backward."""

    @staticmethod
    def forward(ctx, x, wg, wi, wo):
        fn = (_ff.fused_swiglu_with_hidden_op if x.is_cuda
              else _ff.swiglu_plain_with_hidden)
        out, h = fn(x, wg, wi, wo)
        ctx.save_for_backward(x, wg, wi, wo, h)
        return out

    @staticmethod
    def backward(ctx, dy):
        return swiglu_backward(*ctx.saved_tensors, dy)


class RMSNorm(torch.autograd.Function):
    """B4 (or its plain version on the CPU) with its backward formula."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        if x.is_cuda:
            out = _rn.fused_rmsnorm_op(x, scale, eps)
        else:
            out = _rn.rmsnorm_plain(x, scale, eps)
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return out

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        return (*rmsnorm_backward(x, scale, dy, ctx.eps), None)
