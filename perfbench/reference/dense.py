"""The SwiGLU feed-forward layer, ``(silu(x Wg) * (x Wi)) Wo``, in fp32."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .linear import linear

PORT = "dense"
KEY = "ffn"


def swiglu_leaves(d: int, f: int, lead: Tuple[int, ...] = ()) -> dict:
    """A SwiGLU's ``wi``, ``wg`` ``[d, f]`` and ``wo`` ``[f, d]``, each
    behind the dims ``lead``."""
    return {"wi": (lead + (d, f), ("fan_in", d)),
            "wg": (lead + (d, f), ("fan_in", d)),
            "wo": (lead + (f, d), ("fan_in", f))}


def leaves(cfg) -> dict:
    return swiglu_leaves(cfg.d_model, cfg.d_ff)


def apply(p: dict, x: torch.Tensor, quant=None) -> torch.Tensor:
    hidden = F.silu(linear(x, p["wg"], quant)) * linear(x, p["wi"], quant)
    return linear(hidden, p["wo"], quant)


def residual(p: dict, c: dict, x: torch.Tensor, fwd) -> torch.Tensor:
    return apply(p, x, fwd.quant)


def params(c: dict) -> int:
    return 3 * c["hidden_size"] * c["intermediate_size"]
