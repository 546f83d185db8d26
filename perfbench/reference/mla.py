"""Multi-head latent attention (DeepSeek-V2, arXiv:2405.04434 §2.1), in
fp32: queries through the q LoRA and its norm, keys and values expanded
from the normed kv latent, the 64 rope columns of q and of the one shared
rope key rotated, softmax over ``qk_nope + qk_rope`` columns.  The full
forward over the sequence: the latent cache a server keeps is this
expansion's input, so prefill and decode through it compute the same.

A variant builds its queries its own way, or rotates differently, and
hands them to :func:`attend`."""

from __future__ import annotations

import math
from typing import Callable

import torch

from .attention import causal
from .linear import linear
from .norm import rmsnorm, rope

PORT = "attn_mla"
KEY = "mixer"


def leaves(cfg) -> dict:
    """The port's MLA leaves, the q LoRA's among them."""
    d, h = cfg.d_model, cfg.n_heads
    dn, dv, r = cfg.head_dim, cfg.v_dim, cfg.rope_head_dim
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    return {"wdq": ((d, qr), ("fan_in", d)),
            "q_norm": {"scale": ((qr,), ("scale",))},
            "wuq": ((qr, h, dn + r), ("fan_in", qr)),
            "wdkv": ((d, kvr + r), ("fan_in", d)),
            "kv_norm": {"scale": ((kvr,), ("scale",))},
            "wukv": ((kvr, h, dn + dv), ("fan_in", kvr)),
            "wo": ((h, dv, d), ("fan_in", h * dv))}


def attend(p: dict, c: dict, x: torch.Tensor, q: torch.Tensor,
           rotate: Callable[[torch.Tensor], torch.Tensor],
           quant=None) -> torch.Tensor:
    """MLA over the queries ``q [B, S, h, dn + r]``: ``rotate`` applied to
    q's rope columns and to the shared rope key, keys and values expanded
    from the normed kv latent, causal softmax, out-projection."""
    B, S, d = x.shape
    h = c["num_attention_heads"]
    dn, r, dv = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"]
    kvr = c["kv_lora_rank"]
    q = torch.cat([q[..., :dn], rotate(q[..., dn:])], dim=-1)

    latent = linear(x, p["wdkv"], quant)                     # [B,S,kvr+r]
    ckv = rmsnorm(latent[..., :kvr], p["kv_norm"]["scale"], c["rms_norm_eps"])
    k_pe = rotate(latent[..., None, kvr:])                   # [B,S,1,r]
    kv = linear(ckv, p["wukv"].reshape(kvr, h * (dn + dv)), quant)
    kv = kv.view(B, S, h, dn + dv)
    k = torch.cat([kv[..., :dn], k_pe.expand(B, S, h, r)], dim=-1)
    o = causal(q, k, kv[..., dn:], 1.0 / math.sqrt(dn + r))
    return linear(o.reshape(B, S, h * dv), p["wo"].reshape(h * dv, d), quant)


def apply(p: dict, c: dict, x: torch.Tensor, pos: torch.Tensor,
          quant=None) -> torch.Tensor:
    B, S, d = x.shape
    h = c["num_attention_heads"]
    dn, r = c["qk_nope_head_dim"], c["qk_rope_head_dim"]
    qr = c["q_lora_rank"]
    theta = c["rope_theta"]
    yarn = c.get("rope_scaling") or {}
    if yarn.get("factor", 1) != 1:
        # YaRN at factor 1 neither blends frequencies nor scales softmax
        # (its mscale is 1), so plain RoPE computes it; other factors do.
        raise ValueError("the reference runs YaRN only at factor 1")

    cq = rmsnorm(linear(x, p["wdq"], quant), p["q_norm"]["scale"],
                 c["rms_norm_eps"])
    q = linear(cq, p["wuq"].reshape(qr, h * (dn + r)), quant)
    return attend(p, c, x, q.view(B, S, h, dn + r),
                  lambda t: rope(t, pos, theta), quant)


def residual(p: dict, c: dict, x: torch.Tensor, fwd) -> torch.Tensor:
    return apply(p, c, x, fwd.pos, fwd.quant)


def params(c: dict) -> int:
    """The weights of its projections, from the published keys (the q
    LoRA's where ``q_lora_rank`` is not 0)."""
    d, h = c["hidden_size"], c["num_attention_heads"]
    dn, r, dv = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                 c["v_head_dim"])
    qr, kvr = c["q_lora_rank"], c["kv_lora_rank"]
    q = d * qr + qr * h * (dn + r) if qr else d * h * (dn + r)
    return q + d * (kvr + r) + kvr * h * (dn + dv) + h * dv * d


def pair_flops(c: dict) -> int:
    """``2 H (dqk + dv)``."""
    return 2 * c["num_attention_heads"] * (
        c["qk_nope_head_dim"] + c["qk_rope_head_dim"] + c["v_head_dim"])
