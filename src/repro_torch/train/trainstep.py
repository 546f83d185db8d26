"""Train and eval steps: loss, gradients, microbatch accumulation and
AdamW (the JAX package's ``repro.train.trainstep``), in eager torch.

With microbatches the batch's leading dim is split into ``microbatches``
equal parts; the gradients are the mean of theirs, and ``loss_total`` and
the model's metrics are the last microbatch's (the reference's scan keeps
its last carry and metrics), not an average.

The parameters may be ``DTensor``s on a device mesh (placed by their
logical axes, :mod:`repro_torch.parallel.sharding`, under
``mesh_context``); the batch is then the global batch on every rank, as
plain tensors, which the step treats as replicated
(``implicit_replication``) until ``shard`` places the embeddings.  Each
gradient is redistributed to its parameter's placements (the data-parallel
all-reduce), and the metrics come back as plain tensors.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.models import lm_loss
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import tree_map
from repro_torch.parallel.sharding import is_dtensor

from .optimizer import AdamWConfig, AdamWState, adamw_update


def _unflatten(template, leaves: List[torch.Tensor]):
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)


def _mesh_scope(params):
    """``implicit_replication()`` when ``params`` are ``DTensor``s (plain
    tensors beside them read as replicated), else a null context."""
    first: List[torch.Tensor] = []
    tree_map(first.append, params)
    if first and is_dtensor(first[0]):
        from torch.distributed.tensor.experimental import implicit_replication

        return implicit_replication()
    return nullcontext()


def _plain(t: torch.Tensor) -> torch.Tensor:
    """A ``DTensor`` gathered to a plain tensor (a scalar metric);
    anything else as it is."""
    return t.full_tensor() if is_dtensor(t) else t


def _placed_like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A ``DTensor`` gradient redistributed to its parameter's placements
    (partial sums over the data shards reduced)."""
    if is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def loss_and_grads(cfg: ModelConfig, params, batch: Dict[str, Any]
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Any]:
    """(total loss, metrics, gradients) of :func:`lm_loss` at ``params``
    on one (micro)batch; the gradient tree mirrors ``params``, a leaf the
    loss does not reach gets zeros."""
    leaves: List[torch.Tensor] = []
    tree_map(leaves.append, params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad(), _mesh_scope(params):
        loss, metrics = lm_loss(_unflatten(params, live), cfg, batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else _placed_like(g, p)
                 for p, g in zip(leaves, grads)]
    return (_plain(loss.detach()),
            {k: _plain(v.detach()) for k, v in metrics.items()},
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
            with _mesh_scope(params):
                acc = g_leaves if not acc else [
                    a.add_(b) for a, b in zip(acc, g_leaves)]
        with _mesh_scope(params):
            acc = [a.div_(microbatches) for a in acc]
        return loss, metrics, _unflatten(params, acc)

    def train_step(params, opt_state: AdamWState, batch: Dict[str, Any]):
        loss, metrics, grads = grads_of(params, batch)
        with _mesh_scope(params):
            params, opt_state, opt_metrics = adamw_update(
                grads, opt_state, params, opt_cfg)
        metrics = dict(metrics)
        metrics.update({k: _plain(v) for k, v in opt_metrics.items()})
        metrics["loss_total"] = loss
        return params, opt_state, metrics

    return train_step


def make_eval_step(cfg: ModelConfig):
    @torch.no_grad()
    def eval_step(params, batch):
        _, metrics = lm_loss(params, cfg, batch)
        return metrics

    return eval_step
