"""Products of the reference: plain fp32 with TF32 off, and the fp8
control's rounding of both operands."""

from __future__ import annotations

from typing import Optional

import torch

#: the control's precision: e4m3 operands, x scaled a row and w a column
FP8 = "fp8"
#: bf16 operands (fp32 sums), the program's own precision of the products
BF16 = "bf16"
E4M3_MAX = 448.0


def precise() -> None:
    """fp32 products in full fp32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3, scaled along ``dim`` so that its
    largest magnitude there maps to e4m3's largest, back in fp32."""
    s = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / E4M3_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


def linear(x: torch.Tensor, w: torch.Tensor,
           quant: Optional[str] = None) -> torch.Tensor:
    """``x [..., k] @ w [k, n]`` in fp32; with ``quant`` "fp8" both
    operands rounded to e4m3 first (x a row, w an output column), with
    "bf16" to bf16."""
    x, w = x.float(), w.float()
    if quant == FP8:
        x, w = fp8(x, -1), fp8(w, 0)
    elif quant == BF16:
        x, w = x.bfloat16().float(), w.bfloat16().float()
    elif quant is not None:
        raise ValueError(quant)
    return x @ w
