"""Public wrappers of the LM kernels, dispatching on the tensor's device.

A CUDA tensor goes through the hand-written kernel (``fused_rmsnorm``,
``fused_swiglu``, ``flash_attention``), which launches or raises; a CPU
tensor goes through the kernel's plain torch version.  Nothing falls back
from one to the other.  While grad is enabled and an input requires grad,
the call goes through the kernel's ``torch.autograd.Function``
(:mod:`repro_torch.kernels.autograd`: the same forward, an explicit
backward); otherwise straight to the kernel, at no extra host cost.  (A
kernel wrapper called directly on such inputs raises: its output would
carry no ``grad_fn`` and cut the graph.)  Unlike the JAX package's
wrappers these take no block sizes (each kernel picks its own tiles) and
no ``use_kernel`` switch (the ``*_plain`` functions are that switch, on
any device).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import autograd
from .flash_attention import attention_plain, flash_attention
from .fused_ffn import fused_swiglu, swiglu_plain
from .rmsnorm import fused_rmsnorm, rmsnorm_plain


def _on_cuda(name: str, t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name} runs on cuda or cpu tensors, not {t.device}")


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: int = 0,
              scale: Optional[float] = None) -> torch.Tensor:
    """q ``[B, H, S, d]``, k, v ``[B, Hkv, S, d]`` -> ``[B, H, S, d]``."""
    cuda = _on_cuda("attention", q)
    if _needs_grad(q, k, v):
        return autograd.Attention.apply(q, k, v, causal, window, scale)
    if cuda:
        return flash_attention(q, k, v, causal=causal, window=window,
                               scale=scale)
    return attention_plain(q, k, v, causal=causal, window=window,
                           scale=scale)


def swiglu(x: torch.Tensor, wg: torch.Tensor, wi: torch.Tensor,
           wo: torch.Tensor) -> torch.Tensor:
    """x ``[M, d]``; wg, wi ``[d, f]``; wo ``[f, d]`` -> ``[M, d]``."""
    cuda = _on_cuda("swiglu", x)
    if _needs_grad(x, wg, wi, wo):
        return autograd.SwiGLU.apply(x, wg, wi, wo)
    if cuda:
        return fused_swiglu(x, wg, wi, wo)
    return swiglu_plain(x, wg, wi, wo)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """x ``[M, d]``; scale ``[d]`` -> ``[M, d]``."""
    cuda = _on_cuda("rmsnorm", x)
    if _needs_grad(x, scale):
        return autograd.RMSNorm.apply(x, scale, eps)
    if cuda:
        return fused_rmsnorm(x, scale, eps)
    return rmsnorm_plain(x, scale, eps)
