"""Routed experts with a capacity, and shared experts, in fp32.

Each token's gates are the softmax of its router logits over the experts;
it takes its ``top_k`` experts, their gates renormalised to sum 1.  The
capacity is per sequence and per forward, as a server runs them: the
prompt is one forward, and each later token its own.  A forward of S
tokens gives each expert ``C = max(1, int(capacity_factor * top_k * S /
E))`` slots, filled by the tokens that chose it in token order; a choice
past them is dropped and adds nothing.  The shared experts see every
token.  The router and its softmax stay in fp32 under the fp8 control."""

from __future__ import annotations

import torch

from . import dense
from .linear import linear


def route(c: dict, router: torch.Tensor, x: torch.Tensor,
          prompt_len: int, margins: list = None) -> torch.Tensor:
    """The weight of each expert for each token, ``[B, S, E]``: its
    renormalised gate where it chose the expert and was not dropped, else
    0.  ``margins``, where given, gets each token's router-logit margin
    between its last chosen expert and the first one left out ``[B, S]``:
    how near the choice is to a tie."""
    B, S, _ = x.shape
    E = router.shape[1]
    k = c["num_experts_per_tok"]
    cf = c["assumed"]["capacity_factor"]
    logits = linear(x, router)
    if margins is not None:
        top = logits.topk(k + 1, dim=-1).values
        margins.append(top[..., k - 1] - top[..., k])
    gates = torch.softmax(logits, dim=-1)
    topv, topi = torch.topk(gates, k, dim=-1)
    topv = topv / topv.sum(-1, keepdim=True)
    chosen = torch.zeros((B, S, E), dtype=torch.bool, device=x.device)
    chosen.scatter_(2, topi, True)
    rank = torch.zeros((B, S, E), dtype=torch.long, device=x.device)
    rank[:, :prompt_len] = chosen[:, :prompt_len].long().cumsum(1) - 1
    cap = torch.full((S,), max(1, int(cf * k * 1 / E)), device=x.device)
    cap[:prompt_len] = max(1, int(cf * k * prompt_len / E))
    keep = chosen & (rank < cap[None, :, None])
    w = torch.zeros((B, S, E), device=x.device).scatter_(2, topi, topv)
    return w * keep


def apply(p: dict, c: dict, x: torch.Tensor, prompt_len: int,
          quant=None, margins: list = None) -> torch.Tensor:
    B, S, d = x.shape
    w = route(c, p["router"], x, prompt_len, margins).view(B * S, -1)
    xf = x.reshape(B * S, d).float()
    out = torch.zeros_like(xf)
    for e in range(w.shape[1]):
        rows = w[:, e].nonzero().squeeze(1)
        if rows.numel():
            ye = dense.apply({n: p[n][e] for n in ("wi", "wg", "wo")},
                             xf[rows], quant)
            out.index_add_(0, rows, ye * w[rows, e, None])
    out = out.view(B, S, d)
    if "shared" in p:
        out = out + dense.apply(p["shared"], x, quant)
    return out
