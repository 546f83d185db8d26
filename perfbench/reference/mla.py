"""Multi-head latent attention (DeepSeek-V2, arXiv:2405.04434 §2.1), in
fp32: queries through the q LoRA and its norm, keys and values expanded
from the normed kv latent, the 64 rope columns of q and of the one shared
rope key rotated, softmax over ``qk_nope + qk_rope`` columns.  The full
forward over the sequence: the latent cache a server keeps is this
expansion's input, so prefill and decode through it compute the same."""

from __future__ import annotations

import math

import torch

from .attention import causal
from .linear import linear
from .norm import rmsnorm, rope


def apply(p: dict, c: dict, x: torch.Tensor, pos: torch.Tensor,
          quant=None) -> torch.Tensor:
    B, S, d = x.shape
    h = c["num_attention_heads"]
    dn, r, dv = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"]
    qr, kvr = c["q_lora_rank"], c["kv_lora_rank"]
    eps, theta = c["rms_norm_eps"], c["rope_theta"]
    yarn = c.get("rope_scaling") or {}
    if yarn.get("factor", 1) != 1:
        # YaRN at factor 1 neither blends frequencies nor scales softmax
        # (its mscale is 1), so plain RoPE computes it; other factors do.
        raise ValueError("the reference runs YaRN only at factor 1")

    cq = rmsnorm(linear(x, p["wdq"], quant), p["q_norm"]["scale"], eps)
    q = linear(cq, p["wuq"].reshape(qr, h * (dn + r)), quant)
    q = q.view(B, S, h, dn + r)
    q = torch.cat([q[..., :dn], rope(q[..., dn:], pos, theta)], dim=-1)

    latent = linear(x, p["wdkv"], quant)                     # [B,S,kvr+r]
    ckv = rmsnorm(latent[..., :kvr], p["kv_norm"]["scale"], eps)
    k_pe = rope(latent[..., None, kvr:], pos, theta)         # [B,S,1,r]
    kv = linear(ckv, p["wukv"].reshape(kvr, h * (dn + dv)), quant)
    kv = kv.view(B, S, h, dn + dv)
    k = torch.cat([kv[..., :dn], k_pe.expand(B, S, h, r)], dim=-1)
    o = causal(q, k, kv[..., dn:], 1.0 / math.sqrt(dn + r))
    return linear(o.reshape(B, S, h * dv), p["wo"].reshape(h * dv, d), quant)
