"""The SwiGLU feed-forward layer, ``(silu(x Wg) * (x Wi)) Wo``, in fp32."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .linear import linear


def apply(p: dict, x: torch.Tensor, quant=None) -> torch.Tensor:
    hidden = F.silu(linear(x, p["wg"], quant)) * linear(x, p["wi"], quant)
    return linear(hidden, p["wo"], quant)
