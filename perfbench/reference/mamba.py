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

PORT = "mamba"
KEY = "mixer"


def leaves(cfg) -> dict:
    """The port's Mamba leaves: conv bias 0.1 N(0, 1), ``D`` ones,
    ``A_log`` = log(1..n) on every channel, ``dt_bias`` from the Mamba
    init."""
    d = cfg.d_model
    di = cfg.mamba_expand * d
    n, k = cfg.mamba_d_state, cfg.mamba_d_conv
    dtr = max(1, math.ceil(d / 16))
    return {"in_proj": ((d, 2 * di), ("fan_in", d)),
            "conv_w": ((k, di), ("fan_in", k)),
            "conv_b": ((di,), ("normal", 0.1)),
            "x_proj": ((di, dtr + 2 * n), ("fan_in", di)),
            "dt_proj": ((dtr, di), ("fan_in", dtr)),
            "dt_bias": ((di,), ("dt_bias",)),
            "A_log": ((di, n), ("a_log",)),
            "D": ((di,), ("ones",)),
            "out_proj": ((di, d), ("fan_in", di))}


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


def residual(p: dict, c: dict, x: torch.Tensor, fwd) -> torch.Tensor:
    return apply(p, c, x, fwd.quant)


def params(c: dict) -> int:
    d = c["hidden_size"]
    di = c["mamba_expand"] * d
    n, dtr = c["mamba_d_state"], c["mamba_dt_rank"]
    return d * 2 * di + di * (dtr + 2 * n) + dtr * di + di * d


def token_flops(c: dict) -> int:
    """The depthwise conv (``2 K di``) and the scan (``6 di n``: the input
    term, the update and the read-out, a multiply and an add each)."""
    di = c["mamba_expand"] * c["hidden_size"]
    return 2 * c["mamba_d_conv"] * di + 6 * di * c["mamba_d_state"]
