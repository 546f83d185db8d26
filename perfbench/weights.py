"""The benchmark's weights: drawn from the seed on the device, in the dtype
they are served in, in the parameter layout that ``lm_apply`` reads, one
draw a leaf (the scanned layers' leaves stacked, one draw for all of
them).  The program and the reference are handed the same tensors: the
program the layout's tree, the reference one plain dict a layer (views
into the same storage).

Every projection is N(0, 1/fan_in); the embedding N(0, 1); norm scales
1 + 0.1 N(0, 1); Mamba's conv bias 0.1 N(0, 1), ``D`` ones, ``A_log`` =
log(1..n) on every channel and ``dt_bias`` from the Mamba init
(softplus(dt_bias) log-uniform in [0.001, 0.1]).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

#: the port's mixer kinds by the names the configuration files use (the
#: FFN kinds, "dense" and "moe", are the same in both)
MIXERS = {"attn_mla": "mla", "attn": "gqa", "mamba": "mamba"}


def _normal(fan_in: int) -> tuple:
    return ("normal", 1.0 / math.sqrt(fan_in))


SCALE = ("scale",)


def _mixer(cfg, kind: str) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    if kind == "mla":
        dn, dv, r = cfg.head_dim, cfg.v_dim, cfg.rope_head_dim
        qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
        return {"wdq": ((d, qr), _normal(d)),
                "q_norm": {"scale": ((qr,), SCALE)},
                "wuq": ((qr, h, dn + r), _normal(qr)),
                "wdkv": ((d, kvr + r), _normal(d)),
                "kv_norm": {"scale": ((kvr,), SCALE)},
                "wukv": ((kvr, h, dn + dv), _normal(kvr)),
                "wo": ((h, dv, d), _normal(h * dv))}
    if kind == "gqa":
        kh, dh, dv = cfg.n_kv_heads, cfg.head_dim, cfg.v_dim
        return {"wq": ((d, h, dh), _normal(d)),
                "wk": ((d, kh, dh), _normal(d)),
                "wv": ((d, kh, dv), _normal(d)),
                "wo": ((h, dv, d), _normal(h * dv))}
    if kind == "mamba":
        di = cfg.mamba_expand * d
        n, k = cfg.mamba_d_state, cfg.mamba_d_conv
        dtr = max(1, math.ceil(d / 16))
        return {"in_proj": ((d, 2 * di), _normal(d)),
                "conv_w": ((k, di), _normal(k)),
                "conv_b": ((di,), ("normal", 0.1)),
                "x_proj": ((di, dtr + 2 * n), _normal(di)),
                "dt_proj": ((dtr, di), _normal(dtr)),
                "dt_bias": ((di,), ("dt_bias",)),
                "A_log": ((di, n), ("a_log",)),
                "D": ((di,), ("ones",)),
                "out_proj": ((di, d), _normal(di))}
    raise ValueError(kind)


def _ffn(d: int, f: int, lead: Tuple[int, ...] = ()) -> dict:
    return {"wi": (lead + (d, f), _normal(d)),
            "wg": (lead + (d, f), _normal(d)),
            "wo": (lead + (f, d), _normal(f))}


def block_spec(cfg, mixer: str, ffn: str) -> dict:
    """One layer's leaves: (shape, init) each, in the layout
    ``block_apply`` reads."""
    d = cfg.d_model
    spec = {"norm1": {"scale": ((d,), SCALE)}, "mixer": _mixer(cfg, mixer),
            "norm2": {"scale": ((d,), SCALE)}}
    if ffn == "dense":
        spec["ffn"] = _ffn(d, cfg.d_ff)
    else:
        moe = {"router": ((d, cfg.n_experts), _normal(d)),
               **_ffn(d, cfg.d_ff_expert, (cfg.n_experts,))}
        if cfg.n_shared_experts:
            moe["shared"] = _ffn(d, cfg.d_ff_expert * cfg.n_shared_experts)
        spec["moe"] = moe
    return spec


def _fill(t: torch.Tensor, init: tuple, gen: torch.Generator) -> None:
    kind = init[0]
    if kind == "normal":
        t.normal_(0.0, init[1], generator=gen)
    elif kind == "scale":
        t.normal_(1.0, 0.1, generator=gen)
    elif kind == "ones":
        t.fill_(1.0)
    elif kind == "a_log":
        n = t.shape[-1]
        t.copy_(torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                       device=t.device)).expand(t.shape))
    elif kind == "dt_bias":
        u = torch.rand(t.shape, generator=gen, device=t.device)
        dt = torch.exp(u * (math.log(0.1) - math.log(0.001))
                       + math.log(0.001))
        t.copy_(dt + torch.log(-torch.expm1(-dt)))
    else:
        raise ValueError(init)


def _draw(spec, lead: Tuple[int, ...], gen, dtype, device):
    if isinstance(spec, dict):
        return {k: _draw(v, lead, gen, dtype, device)
                for k, v in spec.items()}
    shape, init = spec
    t = torch.empty(lead + tuple(shape), dtype=dtype, device=device)
    _fill(t, init, gen)
    return t


def _index(tree, r: int):
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    return tree[r]


def layer_kinds(cfg) -> List[List[str]]:
    """The port's layers as [mixer, ffn] in the configuration files'
    names."""
    return [[MIXERS[s.mixer], s.ffn] for s in cfg.block_specs()]


def draw(cfg, seed: int, device) -> Tuple[Dict, Dict]:
    """(the tree ``lm_apply`` reads, the reference's weights: ``embed``,
    ``head``, ``final_norm`` and one tree a layer in ``layers``), drawn
    from ``seed`` on ``device`` in ``cfg.param_dtype``."""
    dtype = getattr(torch, cfg.param_dtype)
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    kinds = layer_kinds(cfg)
    pre, p, reps, rem = cfg.layout()
    d, v = cfg.d_model, cfg.vocab
    top = _draw({"embed": ((v, d), ("normal", 1.0)),
                 "final_norm": {"scale": ((d,), SCALE)},
                 "head": ((d, v), _normal(d))}, (), gen, dtype, device)
    layers: List[Dict] = [None] * cfg.n_layers
    tree = {**top, "pre": {}, "scan": {}, "rest": {}}
    for j in range(pre):
        tree["pre"][f"q{j}"] = layers[j] = _draw(
            block_spec(cfg, *kinds[j]), (), gen, dtype, device)
    for pos in range(p if reps else 0):
        stacked = _draw(block_spec(cfg, *kinds[pre + pos]), (reps,), gen,
                        dtype, device)
        tree["scan"][f"p{pos}"] = stacked
        for r in range(reps):
            layers[pre + r * p + pos] = _index(stacked, r)
    for j in range(rem):
        li = pre + reps * p + j
        tree["rest"][f"r{j}"] = layers[li] = _draw(
            block_spec(cfg, *kinds[li]), (), gen, dtype, device)
    return tree, {**top, "layers": layers}
