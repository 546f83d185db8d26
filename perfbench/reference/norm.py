"""RMSNorm and rotary embeddings of the reference, in fp32."""

from __future__ import annotations

import torch


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """``x / rms(x) * scale`` over the last dim, in fp32."""
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.float()


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half rotary embedding of ``x [..., S, H, r]`` at positions
    ``pos [S]``: the first and second halves of the last dim are the two
    coordinates; frequency ``theta ** (-2i / r)`` for pair ``i``.  Angles
    in float64."""
    r = x.shape[-1]
    inv = theta ** (-torch.arange(0, r, 2, dtype=torch.float64,
                                  device=x.device) / r)
    ang = pos.to(torch.float64)[:, None] * inv              # [S, r/2]
    cos = torch.cos(ang).float()[:, None, :]                # [S, 1, r/2]
    sin = torch.sin(ang).float()[:, None, :]
    x1, x2 = x.float()[..., : r // 2], x.float()[..., r // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
