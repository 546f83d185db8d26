"""AdamW + gradient clipping + LR schedules over the port's parameter
dicts (the JAX package's ``repro.train.optimizer``).

The state mirrors the parameter tree, in ``cfg.state_dtype`` (bf16 for the
largest models).  The reference's semantics are kept, odd ones included:
``step`` counts from 1 inside the update, and weight decay applies to every
leaf with more than one dim, so the stacked norm scales ``[layers, d]``
are decayed.  :func:`adamw_update` writes the new parameters and moments
into the given tensors (the reference's jitted step donates its buffers)
and returns them.  On ``DTensor`` parameters the moments are
``DTensor``s placed alike, and the clipping norm's sum of squares is
reduced over the mesh (``DTensor`` reduces a sharded leaf's sum before
the square root); call the update under ``implicit_replication`` (the
train step does) so its plain scalars read as replicated.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple

import torch

from repro_torch.checkpoint.io import keypath_items
from repro_torch.models.layers import tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor         # int32 scalar
    mu: Any                    # tree like params
    nu: Any                    # tree like params


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"   # "bfloat16" for the 200B+ configs
    schedule: str = "cosine"       # constant | cosine | linear_warmup_cosine
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def _zip_leaves(first, *others):
    """The leaves of trees of one structure, matched by key path (not by
    dict order, which may differ between them)."""
    if isinstance(first, dict):
        for k in first:
            yield from _zip_leaves(first[k], *(o[k] for o in others))
    else:
        yield (first, *others)


def schedule_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (fp32 scalar tensor on its device)."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        frac = torch.ones((), device=s.device)
    else:
        t = torch.clamp((s - cfg.warmup_steps)
                        / max(cfg.total_steps - cfg.warmup_steps, 1),
                        0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def adamw_init(params, cfg: AdamWConfig) -> AdamWState:
    dt = torch.bfloat16 if cfg.state_dtype == "bfloat16" else torch.float32
    first = keypath_items(params)[0][1]

    def zeros(p):  # a DTensor's moments are placed as it is
        return torch.zeros_like(p, dtype=dt,
                                memory_format=torch.contiguous_format)

    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=first.device),
        mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    """The gradients' global L2 norm, summed leaf by leaf in the
    reference's flattening order (dict keys sorted)."""
    sq = [torch.sum(torch.square(g.float()))
          for _, g in keypath_items(tree)]
    total = torch.zeros((), device=sq[0].device if sq else None)
    for x in sq:
        total = total + x
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, cfg: AdamWConfig):
    """Returns (params, state, metrics): the parameters and moments
    updated in place, a new step count, and grad_norm, lr and
    clip_scale."""
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                         max=1.0)
             if cfg.clip_norm else torch.ones((), device=gnorm.device))
    step = state.step + 1
    lr = schedule_lr(cfg, step)
    sf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, device=sf.device), sf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, device=sf.device), sf)

    for g, m, v, p in _zip_leaves(grads, state.mu, state.nu, params):
        g = g.float() * scale
        m_new = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v_new = cfg.b2 * v.float() + (1 - cfg.b2) * torch.square(g)
        delta = (m_new / b1c) / (torch.sqrt(v_new / b2c) + cfg.eps)
        decay = cfg.weight_decay if p.dim() > 1 else 0.0  # not on 1-d
        p_new = p.float() * (1 - lr * decay) - lr * delta
        p.copy_(p_new)
        m.copy_(m_new)
        v.copy_(v_new)
    metrics: Dict[str, torch.Tensor] = {"grad_norm": gnorm, "lr": lr,
                                        "clip_scale": scale}
    return params, AdamWState(step, state.mu, state.nu), metrics
