"""The benchmark's weights: drawn from the seed on the device, in the dtype
they are served in, in the parameter layout that ``lm_apply`` reads, one
draw a leaf (the scanned layers' leaves stacked, one draw for all of
them).  The program and the reference are handed the same tensors: the
program the layout's tree, the reference one plain dict a layer (views
into the same storage).

The embedding is N(0, 1), the head N(0, 1/d), the norm scales 1 + 0.1
N(0, 1); each mechanism (:func:`perfbench.spec.mechanism`) gives its own
leaves, with these inits: ``("fan_in", n)`` N(0, 1/n), ``("normal",
std)``, ``("scale",)`` as the norms, ``("ones",)``, ``("a_log",)``
log(1..n) along the last dim, ``("dt_bias",)`` the Mamba init
(softplus(dt_bias) log-uniform in [0.001, 0.1]).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from perfbench import spec

SCALE = ("scale",)


def block_spec(cfg, mixer: str, ffn: str) -> dict:
    """One layer's leaves: (shape, init) each, in the layout
    ``block_apply`` reads, the mechanisms' (:func:`perfbench.spec.mechanism`)
    under their ``KEY``."""
    d = cfg.d_model
    m, f = spec.mechanism(mixer), spec.mechanism(ffn)
    return {"norm1": {"scale": ((d,), SCALE)}, m.KEY: m.leaves(cfg),
            "norm2": {"scale": ((d,), SCALE)}, f.KEY: f.leaves(cfg)}


def _fill(t: torch.Tensor, init: tuple, gen: torch.Generator) -> None:
    kind = init[0]
    if kind == "fan_in":
        t.normal_(0.0, 1.0 / math.sqrt(init[1]), generator=gen)
    elif kind == "normal":
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


def _draw(leaves, lead: Tuple[int, ...], gen, dtype, device):
    if isinstance(leaves, dict):
        return {k: _draw(v, lead, gen, dtype, device)
                for k, v in leaves.items()}
    shape, init = leaves
    t = torch.empty(lead + tuple(shape), dtype=dtype, device=device)
    _fill(t, init, gen)
    return t


def _index(tree, r: int):
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    return tree[r]


def layer_kinds(cfg) -> List[List[str]]:
    """The port's layers as [mixer, ffn] by the names of the mechanisms
    that stand for their kinds and vary none."""
    return [[spec.base_mechanism(s.mixer), spec.base_mechanism(s.ffn)]
            for s in cfg.block_specs()]


def check_layers(cfg, layers: List[List[str]]) -> None:
    """Raise unless the mechanisms ``layers`` name stand for the port's
    layers, kind for kind."""
    ports = [[spec.mechanism(n).PORT for n in names] for names in layers]
    kinds = [[s.mixer, s.ffn] for s in cfg.block_specs()]
    if ports != kinds:
        raise ValueError(f"the configuration's layers {layers} stand for "
                         f"{ports}, not the program's {kinds}")
    pre, p, reps, _ = cfg.layout()
    for pos in range(p if reps else 0):
        stacked = {tuple(layers[pre + r * p + pos]) for r in range(reps)}
        if len(stacked) > 1:
            raise ValueError(f"the program stacks the layers {pre + pos}, "
                             f"{pre + pos + p}, ... into one scan: they "
                             f"need the same mechanisms, not "
                             f"{sorted(stacked)}")


def draw(cfg, seed: int, device,
         layers: List[List[str]] = None) -> Tuple[Dict, Dict]:
    """(the tree ``lm_apply`` reads, the reference's weights: ``embed``,
    ``head``, ``final_norm`` and one tree a layer in ``layers``), drawn
    from ``seed`` on ``device`` in ``cfg.param_dtype``; the layers' leaves
    those of the mechanisms ``layers`` names (by default
    :func:`layer_kinds`)."""
    dtype = getattr(torch, cfg.param_dtype)
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    kinds = layers or layer_kinds(cfg)
    pre, p, reps, rem = cfg.layout()
    d, v = cfg.d_model, cfg.vocab
    top = _draw({"embed": ((v, d), ("normal", 1.0)),
                 "final_norm": {"scale": ((d,), SCALE)},
                 "head": ((d, v), ("fan_in", d))}, (), gen, dtype, device)
    per_layer: List[Dict] = [None] * cfg.n_layers
    tree = {**top, "pre": {}, "scan": {}, "rest": {}}
    for j in range(pre):
        tree["pre"][f"q{j}"] = per_layer[j] = _draw(
            block_spec(cfg, *kinds[j]), (), gen, dtype, device)
    for pos in range(p if reps else 0):
        stacked = _draw(block_spec(cfg, *kinds[pre + pos]), (reps,), gen,
                        dtype, device)
        tree["scan"][f"p{pos}"] = stacked
        for r in range(reps):
            per_layer[pre + r * p + pos] = _index(stacked, r)
    for j in range(rem):
        li = pre + reps * p + j
        tree["rest"][f"r{j}"] = per_layer[li] = _draw(
            block_spec(cfg, *kinds[li]), (), gen, dtype, device)
    return tree, {**top, "layers": per_layer}
