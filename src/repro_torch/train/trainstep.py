"""Train and eval steps: loss, gradients, microbatch accumulation and
AdamW (the JAX package's ``repro.train.trainstep``), in eager torch.

With microbatches the batch's leading dim is split into ``microbatches``
equal parts; the gradients are the mean of theirs, and ``loss_total`` and
the model's metrics are the last microbatch's (the reference's scan keeps
its last carry and metrics), not an average.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from repro_torch.models import lm_loss
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import tree_map

from .optimizer import AdamWConfig, AdamWState, adamw_update


def _unflatten(template, leaves: List[torch.Tensor]):
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)


def loss_and_grads(cfg: ModelConfig, params, batch: Dict[str, Any]
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Any]:
    """(total loss, metrics, gradients) of :func:`lm_loss` at ``params``
    on one (micro)batch; the gradient tree mirrors ``params``, a leaf the
    loss does not reach gets zeros."""
    leaves: List[torch.Tensor] = []
    tree_map(leaves.append, params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        loss, metrics = lm_loss(_unflatten(params, live), cfg, batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            _unflatten(params, grads))


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    microbatches: int = 1):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt,
    metrics)``; ``batch`` leaves have a leading ``[global_batch, ...]``
    dim.  The parameters and moments are updated in place."""

    def grads_of(params, batch):
        if microbatches == 1:
            return loss_and_grads(cfg, params, batch)
        acc: List[torch.Tensor] = []
        for i in range(microbatches):
            n = next(iter(batch.values())).shape[0] // microbatches
            loss, metrics, g = loss_and_grads(
                cfg, params, {k: v[i * n:(i + 1) * n]
                              for k, v in batch.items()})
            g_leaves: List[torch.Tensor] = []
            tree_map(g_leaves.append, g)
            acc = g_leaves if not acc else [
                a.add_(b) for a, b in zip(acc, g_leaves)]
        return loss, metrics, _unflatten(
            params, [a.div_(microbatches) for a in acc])

    def train_step(params, opt_state: AdamWState, batch: Dict[str, Any]):
        loss, metrics, grads = grads_of(params, batch)
        params, opt_state, opt_metrics = adamw_update(
            grads, opt_state, params, opt_cfg)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss_total"] = loss
        return params, opt_state, metrics

    return train_step


def make_eval_step(cfg: ModelConfig):
    @torch.no_grad()
    def eval_step(params, batch):
        _, metrics = lm_loss(params, cfg, batch)
        return metrics

    return eval_step
