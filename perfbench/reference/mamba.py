"""The Mamba mixer (selective SSM, arXiv:2312.00752 Alg. 2), in fp32:
in-projection to u and the gate z, a causal depthwise conv with bias and
SiLU, dt, B and C from u, ``h_t = exp(dt_t A) h_{t-1} + dt_t u_t B_t`` run
in time order from zero, ``y_t = h_t C_t + D u_t``, gated by ``silu(z)``,
out-projection."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .linear import linear

#: time steps whose ``exp(dt A)`` is made at once
CHUNK = 256


def apply(p: dict, c: dict, x: torch.Tensor, quant=None) -> torch.Tensor:
    B, S, d = x.shape
    di = c["mamba_expand"] * d
    n, K = c["mamba_d_state"], c["mamba_d_conv"]
    dtr = c.get("mamba_dt_rank") or math.ceil(d / 16)

    uz = linear(x, p["in_proj"], quant)
    u, z = uz[..., :di], uz[..., di:]
    w = p["conv_w"].float()
    upad = F.pad(u, (0, 0, K - 1, 0))
    u = sum(upad[:, i:i + S] * w[i] for i in range(K)) + p["conv_b"].float()
    u = F.silu(u)

    xdbc = linear(u, p["x_proj"], quant)
    dt = F.softplus(linear(xdbc[..., :dtr], p["dt_proj"], quant)
                    + p["dt_bias"].float())                  # [B,S,di]
    Bm, Cm = xdbc[..., dtr:dtr + n], xdbc[..., dtr + n:]      # [B,S,n]
    A = -torch.exp(p["A_log"].float())                       # [di,n]

    y = torch.empty((B, S, di), device=x.device)
    h = torch.zeros((B, di, n), device=x.device)
    for t0 in range(0, S, CHUNK):
        t1 = min(S, t0 + CHUNK)
        decay = torch.exp(dt[:, t0:t1, :, None] * A)         # [B,L,di,n]
        hs = (dt[:, t0:t1] * u[:, t0:t1])[..., None] * Bm[:, t0:t1, None, :]
        for t in range(t1 - t0):
            h = hs[:, t].addcmul_(decay[:, t], h)
        y[:, t0:t1] = torch.einsum("bldn,bln->bld", hs, Cm[:, t0:t1])
    y = (y + u * p["D"].float()) * F.silu(z)
    return linear(y, p["out_proj"], quant)
