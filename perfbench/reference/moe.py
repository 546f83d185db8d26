"""Routed experts with a capacity, and shared experts, in fp32.

Each token's gates are the softmax of its router logits over the experts;
it takes its ``top_k`` experts, their gates renormalised to sum 1.  The
capacity is per sequence and per forward, as a server runs them: the
prompt is one forward, and each later token its own.  A forward of S
tokens gives each expert ``C = max(1, int(capacity_factor * top_k * S /
E))`` slots, filled by the tokens that chose it in token order; a choice
past them is dropped and adds nothing.  The shared experts see every
token.  The router and its softmax stay in fp32 under the fp8 control.

A variant that scores or weighs its choices another way routes with its
own function and hands the weights to :func:`capacity` and
:func:`experts`."""

from __future__ import annotations

import torch

from . import dense
from .linear import linear

PORT = "moe"
KEY = "moe"


def leaves(cfg) -> dict:
    """The router ``[d, E]``, the experts' SwiGLUs stacked ``[E, ...]``,
    and the shared experts as one SwiGLU of their summed width."""
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    spec = {"router": ((d, e), ("fan_in", d)),
            **dense.swiglu_leaves(d, f, (e,))}
    if cfg.n_shared_experts:
        spec["shared"] = dense.swiglu_leaves(d, f * cfg.n_shared_experts)
    return spec


def capacity(c: dict, topi: torch.Tensor, topv: torch.Tensor, E: int,
             prompt_len: int) -> torch.Tensor:
    """The weight of each expert for each token, ``[B, S, E]``, from its
    chosen experts ``topi [B, S, k]`` and their weights ``topv``: the
    weight where the choice is within the expert's slots, else 0."""
    B, S, k = topi.shape
    cf = c["assumed"]["capacity_factor"]
    chosen = torch.zeros((B, S, E), dtype=torch.bool, device=topi.device)
    chosen.scatter_(2, topi, True)
    rank = torch.zeros((B, S, E), dtype=torch.long, device=topi.device)
    rank[:, :prompt_len] = chosen[:, :prompt_len].long().cumsum(1) - 1
    cap = torch.full((S,), max(1, int(cf * k * 1 / E)), device=topi.device)
    cap[:prompt_len] = max(1, int(cf * k * prompt_len / E))
    keep = chosen & (rank < cap[None, :, None])
    w = torch.zeros((B, S, E), device=topi.device).scatter_(2, topi, topv)
    return w * keep


def route(c: dict, router: torch.Tensor, x: torch.Tensor,
          prompt_len: int, margins: list = None) -> torch.Tensor:
    """The weight of each expert for each token, ``[B, S, E]``: its
    renormalised gate where it chose the expert and was not dropped, else
    0.  ``margins``, where given, gets each token's router-logit margin
    between its last chosen expert and the first one left out ``[B, S]``:
    how near the choice is to a tie."""
    k = c["num_experts_per_tok"]
    logits = linear(x, router)
    if margins is not None:
        top = logits.topk(k + 1, dim=-1).values
        margins.append(top[..., k - 1] - top[..., k])
    gates = torch.softmax(logits, dim=-1)
    topv, topi = torch.topk(gates, k, dim=-1)
    topv = topv / topv.sum(-1, keepdim=True)
    return capacity(c, topi, topv, router.shape[1], prompt_len)


def experts(p: dict, x: torch.Tensor, w: torch.Tensor,
            quant=None) -> torch.Tensor:
    """Each token through the experts it has a weight for, ``w [B, S,
    E]``, the outputs weighed and summed, plus the shared experts."""
    B, S, d = x.shape
    w = w.view(B * S, -1)
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


def apply(p: dict, c: dict, x: torch.Tensor, prompt_len: int,
          quant=None, margins: list = None) -> torch.Tensor:
    return experts(p, x, route(c, p["router"], x, prompt_len, margins),
                   quant)


def residual(p: dict, c: dict, x: torch.Tensor, fwd) -> torch.Tensor:
    return apply(p, c, x, fwd.prompt_len, fwd.quant, fwd.margins)


def params(c: dict) -> int:
    """The router, the ``top-k`` routed experts and the shared ones a
    token passes through (not the program's capacity slots)."""
    d = c["hidden_size"]
    e = c.get("n_routed_experts") or c["num_experts"]
    f = c.get("moe_intermediate_size") or c["intermediate_size"]
    k = c["num_experts_per_tok"] + c.get("n_shared_experts", 0)
    return d * e + k * 3 * d * f
