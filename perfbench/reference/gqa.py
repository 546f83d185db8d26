"""Grouped-query attention with rotary q and k (the attention layer of
the hybrid models), in fp32."""

from __future__ import annotations

import math

import torch

from .attention import causal
from .linear import linear
from .norm import rope


def apply(p: dict, c: dict, x: torch.Tensor, pos: torch.Tensor,
          quant=None) -> torch.Tensor:
    B, S, d = x.shape
    h, kh = c["num_attention_heads"], c["num_key_value_heads"]
    dh = d // h
    theta = c.get("rope_theta", 10000.0)
    q = linear(x, p["wq"].reshape(d, h * dh), quant).view(B, S, h, dh)
    k = linear(x, p["wk"].reshape(d, kh * dh), quant).view(B, S, kh, dh)
    v = linear(x, p["wv"].reshape(d, kh * dh), quant).view(B, S, kh, dh)
    o = causal(rope(q, pos, theta), rope(k, pos, theta), v,
               1.0 / math.sqrt(dh))
    return linear(o.reshape(B, S, h * dh), p["wo"].reshape(h * dh, d), quant)
