"""Causal softmax attention of the reference, one sequence at a time and
a block of heads at a time, in fp32."""

from __future__ import annotations

import torch

#: heads a block: [heads, S, S] fp32 scores at once
HEADS_A_BLOCK = 16


def causal(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           scale: float) -> torch.Tensor:
    """q ``[B, S, H, dqk]``, k ``[B, S, Hkv, dqk]``, v ``[B, S, Hkv, dv]``
    (query head ``h`` reads kv head ``h // (H / Hkv)``) -> ``[B, S, H,
    dv]``: each query attends to the keys at its position and before."""
    B, S, H, _ = q.shape
    g = H // k.shape[2]
    out = q.new_empty((B, S, H, v.shape[-1]), dtype=torch.float32)
    future = torch.ones((S, S), dtype=torch.bool, device=q.device).triu(1)
    for b in range(B):
        for h0 in range(0, H, HEADS_A_BLOCK):
            heads = torch.arange(h0, min(H, h0 + HEADS_A_BLOCK),
                                 device=q.device)
            qh = q[b, :, heads].float().transpose(0, 1)      # [h, S, d]
            kh = k[b, :, heads // g].float().transpose(0, 1)
            vh = v[b, :, heads // g].float().transpose(0, 1)
            s = (qh @ kh.transpose(1, 2)) * scale
            s.masked_fill_(future, float("-inf"))
            out[b, :, h0:h0 + len(heads)] = (
                torch.softmax(s, dim=-1) @ vh).transpose(0, 1)
    return out
