"""Plain torch versions of the LM kernels, line for line the JAX package's
oracles: fp32 math, the result cast back to the input's dtype.

They run on any device.  The wrappers in :mod:`repro_torch.kernels.ops`
take them for CPU tensors, and ``chip_smoke.py`` holds each CUDA kernel
against them on the card.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def attention_ref(q, k, v, causal: bool = True, window: int = 0,
                  scale: Optional[float] = None):
    """q,k,v: [B, H, S, d] -> [B, H, S, d] (fp32 math)."""
    *_, S, d = q.shape
    scale = scale or 1.0 / math.sqrt(d)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    qi = torch.arange(S, device=q.device)[:, None]
    ki = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window:
        mask &= ki > qi - window
    s = torch.where(mask, s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)  # fully-masked rows
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def swiglu_ref(x, wg, wi, wo):
    """x: [M, d]; wg,wi: [d, f]; wo: [f, d] (fp32 accumulation)."""
    xf = x.float()
    h = torch.nn.functional.silu(xf @ wg.float()) * (xf @ wi.float())
    return (h @ wo.float()).to(x.dtype)


def rmsnorm_ref(x, scale, eps: float = 1e-5):
    """x: [M, d]; scale: [d]."""
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)
