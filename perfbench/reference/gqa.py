"""Grouped-query attention with rotary q and k (the attention layer of
the hybrid models), in fp32."""

from __future__ import annotations

import math

import torch

from .attention import causal
from .linear import linear
from .norm import rope

PORT = "attn"
KEY = "mixer"


def leaves(cfg) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    kh, dh, dv = cfg.n_kv_heads, cfg.head_dim, cfg.v_dim
    return {"wq": ((d, h, dh), ("fan_in", d)),
            "wk": ((d, kh, dh), ("fan_in", d)),
            "wv": ((d, kh, dv), ("fan_in", d)),
            "wo": ((h, dv, d), ("fan_in", h * dv))}


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


def residual(p: dict, c: dict, x: torch.Tensor, fwd) -> torch.Tensor:
    return apply(p, c, x, fwd.pos, fwd.quant)


def params(c: dict) -> int:
    d, h = c["hidden_size"], c["num_attention_heads"]
    dh = d // h
    kh = c["num_key_value_heads"]
    return d * h * dh + 2 * d * kh * dh + h * dh * d


def pair_flops(c: dict) -> int:
    """``2 H (dqk + dv)``, both the head width."""
    h = c["num_attention_heads"]
    return 2 * h * 2 * (c["hidden_size"] // h)
