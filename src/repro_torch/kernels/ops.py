"""Public wrappers of the LM kernels, dispatching on the tensor's device.

A CUDA tensor goes through the hand-written kernel as a torch op
(``repro_torch::fused_rmsnorm``, ``fused_swiglu``, ``flash_attention``,
``mla_decode``), which launches or raises; a CPU tensor goes through the
kernel's plain torch version.  Nothing falls back from one to the other.  A fake
``cuda`` tensor (``FakeTensorMode``, as the dry run traces a step) takes
the same op, where the dispatcher sends it to the op's fake
implementation: no branch here tells real from fake.  While grad is
enabled and an input requires grad, the call goes through the kernel's
``torch.autograd.Function`` (:mod:`repro_torch.kernels.autograd`: the
same forward, an explicit backward); otherwise straight to the kernel's
op.  (A kernel wrapper called directly on such inputs raises: its output
would carry no ``grad_fn`` and cut the graph.)  Unlike the JAX package's
wrappers these take no block sizes (each kernel picks its own tiles) and
no ``use_kernel`` switch (the ``*_plain`` functions are that switch, on
any device).

A ``DTensor`` input (the sharded train step, :mod:`repro_torch.parallel`)
goes through ``local_map``: the kernel (or, on the CPU, its plain
version) and its ``autograd.Function`` see this rank's local shards, and
the result is a ``DTensor`` again.  The placements each kernel takes:

* attention: batch and/or heads sharded (k and v as q, whatever their
  widths; heads only where the kv heads split evenly, so each shard keeps
  its GQA groups);
* RMSNorm: rows sharded; the scale replicated, its gradient a partial
  sum over the row shards;
* SwiGLU: rows sharded with the weights replicated, or the ``ff`` dim of
  all three weights sharded with x replicated -- then the output is
  ``Partial()``: ``(silu(x Wg_s) * x Wi_s) Wo_s`` summed over the shards
  is the product;
* any other placement of a mesh dim (a sharded sequence, head or model
  width, a pending sum) is redistributed to ``Replicate()`` on that dim
  first; the redistribution is the only collective a wrapper adds.

The route depends on placements, shapes and flags, never on the device.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.parallel.sharding import is_dtensor

from . import autograd
from .flash_attention import attention_plain, flash_attention_op
from .fused_ffn import fused_swiglu_op, swiglu_plain
from .mla_decode import mla_decode_op, mla_decode_plain
from .rmsnorm import fused_rmsnorm_op, rmsnorm_plain


def _evenly(t, dim: int, mesh, i: int, placement):
    """``placement`` (a ``Shard`` of ``dim``) if ``t`` splits evenly over
    mesh dim ``i`` there, given the mesh dims before ``i`` that shard the
    same tensor dim; ``Replicate()`` otherwise."""
    from torch.distributed.tensor import Replicate

    n = mesh.size(i)
    for j in range(i):
        if t.placements[j] == placement:
            n *= mesh.size(j)
    return placement if t.shape[dim] % n == 0 else Replicate()


def _local_map(fn, out_pl, in_pl, grad_pl, *args):
    from torch.distributed.tensor.experimental import local_map

    # one output: its placements wrapped in a one-tuple (a bare tuple
    # would read as one placement per output)
    return local_map(fn, out_placements=(tuple(out_pl),),
                     in_placements=in_pl,
                     in_grad_placements=grad_pl,
                     redistribute_inputs=True)(*args)


def _attention_dt(q, k, v, causal, window, scale):
    """Attention on ``DTensor`` q, k, v: batch and/or heads sharded."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = q.device_mesh
    pl = []
    for i, p in enumerate(q.placements):
        want = p if p in (Shard(0), Shard(1)) else Replicate()
        if want == Shard(1):  # kv heads must split with the q heads
            want = _evenly(k, 1, mesh, i, _evenly(q, 1, mesh, i, want))
        elif want == Shard(0):
            want = _evenly(q, 0, mesh, i, want)
        pl.append(want)
    pl = tuple(pl)
    return _local_map(
        lambda a, b, c: attention(a, b, c, causal=causal, window=window,
                                  scale=scale),
        pl, (pl, pl, pl), (pl, pl, pl), q, k, v)


def _rows_or_replicate(x, mesh):
    from torch.distributed.tensor import Replicate, Shard

    return tuple(_evenly(x, 0, mesh, i, Shard(0)) if p == Shard(0)
                 else Replicate() for i, p in enumerate(x.placements))


def _rmsnorm_dt(x, scale, eps):
    """RMSNorm on a ``DTensor`` x ``[M, d]``: rows sharded or replicated;
    the scale replicated (its gradient a partial sum over row shards)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = x.device_mesh
    xp = _rows_or_replicate(x, mesh)
    rep = tuple(Replicate() for _ in xp)
    sgrad = tuple(Partial() if p == Shard(0) else Replicate() for p in xp)
    return _local_map(lambda a, b: rmsnorm(a, b, eps), xp, (xp, rep),
                      (xp, sgrad), x, scale)


def _ffn_placements(x, ws, row: int, ff: tuple, lead: bool):
    """Per mesh dim, the placements of a SwiGLU over rows ``row`` of x
    with weights (wg, wi, wo) whose ``ff`` dims are ``ff``: (x, weights,
    out, x grad, weights grad).  ``lead``: a leading expert dim that x
    and the weights may share as ``Shard(0)`` (experts in parallel)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = x.device_mesh
    out = []
    for i, p in enumerate(x.placements):
        wp = tuple(w.placements[i] for w in ws)
        R, P = Replicate(), Partial()
        if (lead and p == Shard(0) and all(q == Shard(0) for q in wp)
                and _evenly(x, 0, mesh, i, p) == p):
            s = Shard(0)
            out.append((s, (s, s, s), s, s, (s, s, s)))
        elif p == Shard(row) and _evenly(x, row, mesh, i, p) == p:
            out.append((p, (R, R, R), p, p, (P, P, P)))
        elif (p != Shard(row) and wp == tuple(Shard(d) for d in ff)
              and all(_evenly(w, d, mesh, i, Shard(d)) == Shard(d)
                      for w, d in zip(ws, ff))):
            out.append((R, wp, P, P, wp))
        else:
            out.append((R, (R, R, R), R, R, (R, R, R)))
    xp, wpl, op, xg, wg = zip(*out)
    wpl = tuple(tuple(w[j] for w in wpl) for j in range(3))
    wg = tuple(tuple(w[j] for w in wg) for j in range(3))
    return xp, wpl, op, xg, wg


def _swiglu_dt(x, wg, wi, wo):
    xp, wpl, op, xg, wgr = _ffn_placements(x, (wg, wi, wo), 0, (1, 1, 0),
                                           lead=False)
    return _local_map(swiglu, op, (xp, *wpl), (xg, *wgr), x, wg, wi, wo)


def _on_cuda(name: str, t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name} runs on cuda or cpu tensors, not {t.device}")


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: int = 0,
              scale: Optional[float] = None) -> torch.Tensor:
    """q ``[B, H, S, dqk]``, k ``[B, Hkv, S, dqk]``, v ``[B, Hkv, S, dv]``
    -> ``[B, H, S, dv]`` (``dv`` = ``dqk``, or narrower at MLA's widths:
    ``flash_attention.WIDTH_PAIRS``; the plain version takes any)."""
    if is_dtensor(q, k, v):
        return _attention_dt(q, k, v, causal, window, scale)
    cuda = _on_cuda("attention", q)
    if _needs_grad(q, k, v):
        return autograd.Attention.apply(q, k, v, causal, window, scale)
    if cuda:
        return flash_attention_op(q, k, v, causal, window, scale)
    return attention_plain(q, k, v, causal=causal, window=window,
                           scale=scale)


def swiglu(x: torch.Tensor, wg: torch.Tensor, wi: torch.Tensor,
           wo: torch.Tensor) -> torch.Tensor:
    """x ``[M, d]``; wg, wi ``[d, f]``; wo ``[f, d]`` -> ``[M, d]``."""
    if is_dtensor(x, wg, wi, wo):
        return _swiglu_dt(x, wg, wi, wo)
    cuda = _on_cuda("swiglu", x)
    if _needs_grad(x, wg, wi, wo):
        return autograd.SwiGLU.apply(x, wg, wi, wo)
    if cuda:
        return fused_swiglu_op(x, wg, wi, wo)
    return swiglu_plain(x, wg, wi, wo)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """x ``[M, d]``; scale ``[d]`` -> ``[M, d]``."""
    if is_dtensor(x, scale):
        return _rmsnorm_dt(x, scale, eps)
    cuda = _on_cuda("rmsnorm", x)
    if _needs_grad(x, scale):
        return autograd.RMSNorm.apply(x, scale, eps)
    if cuda:
        return fused_rmsnorm_op(x, scale, eps)
    return rmsnorm_plain(x, scale, eps)


def swiglu_experts(xe: torch.Tensor, wg: torch.Tensor, wi: torch.Tensor,
                   wo: torch.Tensor) -> torch.Tensor:
    """One :func:`swiglu` per expert: xe ``[E, M, d]``; wg, wi ``[E, d,
    f]``; wo ``[E, f, d]`` -> ``[E, M, d]``.  On ``DTensor``s the experts
    may be sharded (``Shard(0)`` of xe and the weights: each rank runs its
    own), as may the rows or ``ff``, as :func:`swiglu` takes them."""
    if is_dtensor(xe, wg, wi, wo):
        xp, wpl, op, xg, wgr = _ffn_placements(
            xe, (wg, wi, wo), 1, (2, 2, 1), lead=True)
        return _local_map(swiglu_experts, op, (xp, *wpl), (xg, *wgr),
                          xe, wg, wi, wo)
    return torch.stack([swiglu(xe[e], wg[e], wi[e], wo[e])
                        for e in range(xe.shape[0])])


def mla_decode(q_lat: torch.Tensor, q_rope: torch.Tensor,
               ckv: torch.Tensor, k_rope: torch.Tensor,
               positions: torch.Tensor, scale: float) -> torch.Tensor:
    """MLA's decode attention in latent space: q_lat ``[B, H, kvr]``,
    q_rope ``[B, H, r]``, ckv ``[B, T, kvr]``, k_rope ``[B, T, r]``,
    positions ``[B]`` -> ``[B, H, kvr]`` (``mla_decode.LATENT_WIDTHS`` on
    the card; the plain version takes any).  Decode only: no ``DTensor``
    and no autograd (the kernel raises on inputs that require grad)."""
    if _on_cuda("mla_decode", q_lat):
        return mla_decode_op(q_lat, q_rope, ckv, k_rope, positions, scale)
    return mla_decode_plain(q_lat, q_rope, ckv, k_rope, positions, scale)
