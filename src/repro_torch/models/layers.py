"""Functional layers of the port's model zoo: the attention, MLA, dense-FFN,
MoE, Mamba, mLSTM and sLSTM layers of the JAX package's
``repro.models.layers``, with sLSTM's custom VJP (the recurrent weight's
gradient deferred to one contraction after the reverse scan).

Every ``*_init`` returns a tree of nested dicts whose leaves are
:class:`Param` (value + logical axes); ``*_apply`` consumes the matching
*value* tree.  The logical axes place each parameter on a device mesh
(:func:`repro_torch.parallel.sharding.logical_sharding`), and
``shard(...)`` stands where the JAX package's stands: under a mesh it
redistributes a ``DTensor`` activation to its logical placement, without
one it is a no-op.

RMSNorm, the SwiGLU FFN (the dense one and each MoE expert) and, where
their contracts hold, attention and MLA's decode in latent space go through
:mod:`repro_torch.kernels.ops`: the hand-written CUDA kernels on a CUDA
tensor, their plain torch versions on a CPU tensor, the first three under
autograd through their ``torch.autograd.Function`` when a train step needs
the gradient.  Which route a call takes depends on shapes, dtypes and
flags only, never on the device.
Under autograd the Mamba scan and the sLSTM time loop write no tensor in
place (the sLSTM loop runs inside its own Function).

Matrix products promote their operands to a common dtype as the JAX
package's do (a bf16 activation against an fp32 cache gives fp32), so the
port follows the reference under any mix of compute and cache dtypes.
Caches and recurrent states are updated in place (JAX returns new arrays;
the port writes the same slots of the same tensors and returns the dict).

The serving path's layer boundaries are :mod:`repro_torch.obs` spans:
``mla.expand`` and ``mla.attend`` (MLA against a filled cache: its
``wukv`` products and its attention), ``moe.route``, ``moe.experts`` and
``moe.combine``, and ``mamba.scan``; none sits inside a per-expert or
per-step loop.  The counter ``mla.latent_decode`` counts MLA's decode
calls in latent space.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import HEAD_DIMS, WIDTH_PAIRS
from repro_torch.kernels.mla_decode import LATENT_WIDTHS
from repro_torch.parallel.sharding import is_dtensor, shard

from .config import ModelConfig

NEG_INF = -1e30


class Param:
    """A parameter leaf: value + logical axes."""

    __slots__ = ("value", "axes")

    def __init__(self, value, axes: Tuple[Optional[str], ...]):
        self.value = value
        self.axes = tuple(axes)

    def __repr__(self):
        return f"Param({tuple(getattr(self.value, 'shape', ()))}, {self.axes})"


def is_param(x) -> bool:
    return isinstance(x, Param)


def tree_map(fn: Callable, tree, is_leaf: Callable = is_param):
    """``fn`` over the leaves of a tree of nested dicts (a leaf is anything
    that is not a dict, or what ``is_leaf`` accepts)."""
    if is_leaf(tree) or not isinstance(tree, dict):
        return fn(tree)
    return {k: tree_map(fn, v, is_leaf) for k, v in tree.items()}


def param_values(tree):
    return tree_map(lambda p: p.value, tree)


def param_axes(tree):
    return tree_map(lambda p: p.axes, tree)


def tree_cast(tree, dtype):
    """Floating tensors of a value tree to ``dtype`` (others unchanged; a
    tensor already of ``dtype`` is returned as it is, not copied)."""
    return tree_map(
        lambda x: x.to(dtype) if torch.is_floating_point(x) else x, tree)


def _init(gen: torch.Generator, shape, axes, scale=None,
          dtype=torch.float32, device=None) -> Param:
    if scale is None:
        scale = 1.0 / math.sqrt(shape[0])
    val = torch.randn(shape, generator=gen, device=gen.device,
                      dtype=torch.float32) * scale
    return Param(val.to(device=device, dtype=dtype), axes)


def _ones(shape, axes, dtype=torch.float32, device=None) -> Param:
    return Param(torch.ones(shape, dtype=dtype, device=device), axes)


def _zeros(shape, axes, dtype=torch.float32, device=None) -> Param:
    return Param(torch.zeros(shape, dtype=dtype, device=device), axes)


def _elementwise(fn: Callable, x: torch.Tensor, along=()) -> torch.Tensor:
    """``fn(x)`` for an ``fn`` elementwise but along the tensor dims
    ``along``; of a ``DTensor`` through ``local_map`` on each rank's own
    shard, with its placements (a pending sum reduced first, the ``along``
    dims whole), for an op (or its gradient) that ``DTensor`` has no
    sharding rule for, in some torch release."""
    if not is_dtensor(x):
        return fn(x)
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    pl = tuple(Replicate() if p.is_partial() or (p.is_shard()
                                                 and p.dim in along) else p
               for p in x.placements)
    return local_map(fn, out_placements=(pl,), in_placements=(pl,),
                     in_grad_placements=(pl,), redistribute_inputs=True)(x)


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the dtype the two promote to, as jnp does."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def _pad(x: torch.Tensor, pad) -> torch.Tensor:
    """``F.pad(x, pad)`` with zeros, on each rank's own shard of a
    ``DTensor``: ``DTensor``'s own pad fails to plan its redistribution on
    a 2-D mesh in torch 2.11."""
    return _elementwise(lambda t: F.pad(t, pad), x,
                        along={x.dim() - 1 - i // 2 for i in range(len(pad))})


def _mm_rows(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """:func:`_mm` of ``x`` ``[..., k]`` and ``w`` ``[k, n]``; of a
    ``DTensor`` x on each rank's own rows (``local_map``, w replicated):
    its leading dims keep their placements, where a product over them
    flattened would take a strided shard of two sharded dims (as a cache
    sharded by batch and by sequence is), which a trace on fake tensors
    cannot redistribute."""
    if not is_dtensor(x):
        return _mm(x, w)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    last = x.dim() - 1
    pl = tuple(Replicate() if p.is_partial() or p == Shard(last) else p
               for p in x.placements)
    rep = tuple(Replicate() for _ in pl)
    wgrad = tuple(Partial() if p.is_shard() else Replicate() for p in pl)
    return local_map(_mm, out_placements=(pl,), in_placements=(pl, rep),
                     in_grad_placements=(pl, wgrad),
                     redistribute_inputs=True)(x, w)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, dtype=torch.float32, device=None):
    return {"scale": _ones((d,), ("embed",), dtype, device)}


def rmsnorm(params, x, eps: float = 1e-5):
    """Over the last dim of ``x``, through ``ops.rmsnorm`` on ``[-1, d]``;
    the result has ``x``'s dtype."""
    d = x.shape[-1]
    out = ops.rmsnorm(x.reshape(-1, d).contiguous(), params["scale"], eps)
    return out.reshape(x.shape)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def apply_rope(x, positions, theta: float):
    """x: [..., S, H, dh] (rotates the last dim); positions: [..., S]."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                 # [dh/2]
    angles = positions[..., :, None, None].float() * freqs  # [..,S,1,dh/2]
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA, optional sliding window, KV cache)
# ---------------------------------------------------------------------------

def attention_init(gen, cfg: ModelConfig, dtype=torch.float32, device=None):
    d, h, kh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    dh, dv = cfg.head_dim, cfg.v_dim
    p = {
        "wq": _init(gen, (d, h, dh), ("embed", "heads", "head_dim"),
                    dtype=dtype, device=device),
        "wk": _init(gen, (d, kh, dh), ("embed", "kv_heads", "head_dim"),
                    dtype=dtype, device=device),
        "wv": _init(gen, (d, kh, dv), ("embed", "kv_heads", "head_dim"),
                    dtype=dtype, device=device),
        "wo": _init(gen, (h, dv, d), ("heads", "head_dim", "embed"),
                    scale=1.0 / math.sqrt(h * dv), dtype=dtype,
                    device=device),
    }
    if cfg.qk_norm:
        p["qnorm"] = rmsnorm_init(dh, dtype, device)
        p["knorm"] = rmsnorm_init(dh, dtype, device)
    return p


def _attend(q, k, v, mask, softcap: float = 0.0,
            scale: Optional[float] = None):
    """Dense path (short sequences / decode steps).
    q: [B,S,Kh,G,dh]  k: [B,T,Kh,dh]  v: [B,T,Kh,dv]  mask: [B?,S,T]."""
    scale = scale or 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bskgd,btkd->bkgst", q.float(), k.float()) * scale
    if softcap:
        scores = softcap * torch.tanh(scores / softcap)
    scores = torch.where(mask[:, None, None, :, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgst,btkd->bskgd", w.to(v.dtype), v)


def _pick_chunk(n: int, target: int, floor: int = 128) -> int:
    """Largest divisor of n that is <= target (0 if none >= floor)."""
    c = 0
    for d in range(1, int(math.isqrt(n)) + 1):
        if n % d == 0:
            for cand in (d, n // d):
                if floor <= cand <= target and cand > c:
                    c = cand
    return c


def _attend_chunked(q, k, v, qpos, kpos, causal: bool, window: int,
                    softcap: float, cq: int, ck: int,
                    scale: Optional[float] = None):
    """Online-softmax chunked attention, the JAX package's scan over query
    and key chunks as two Python loops: the S x T score matrix never
    exists, only B*cq*H*ck of it at a time.

    q: [B,S,Kh,G,dh]  k: [B,T,Kh,dh]  v: [B,T,Kh,dv]
    qpos: [B,S]  kpos: [T]  ->  [B,S,Kh,G,dv]
    """
    B, S, K, G, dh = q.shape
    T = k.shape[1]
    dv = v.shape[-1]
    scale = scale or 1.0 / math.sqrt(dh)
    nq, nk = S // cq, T // ck
    outs = []
    for i in range(nq):
        qi = q[:, i * cq:(i + 1) * cq].float()
        qpi = qpos[:, i * cq:(i + 1) * cq]
        m = torch.full((B, cq, K, G), NEG_INF, device=q.device)
        l = torch.zeros((B, cq, K, G), device=q.device)
        acc = torch.zeros((B, cq, K, G, dv), device=q.device)
        for j in range(nk):
            kj = k[:, j * ck:(j + 1) * ck].float()
            vj = v[:, j * ck:(j + 1) * ck].float()
            kpj = kpos[j * ck:(j + 1) * ck]
            s = torch.einsum("bqkgd,btkd->bqkgt", qi, kj) * scale
            if softcap:
                s = softcap * torch.tanh(s / softcap)
            mask = (kpj >= 0)[None, None, :].expand(B, cq, -1)
            if causal:
                mask = mask & (kpj[None, None, :] <= qpi[:, :, None])
            if window:
                mask = mask & (kpj[None, None, :] > qpi[:, :, None] - window)
            mask = mask[:, :, None, None, :]
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bqkgt,btkv->bqkgv", p, vj)
            m = m_new
        outs.append((acc / l.clamp_min(1e-30)[..., None]).to(v.dtype))
    return torch.cat(outs, dim=1)


def _dispatch_attend(q, k, v, qpos, kpos, causal, window, softcap,
                     chunk: int, scale=None):
    """Choose chunked (long-seq prefill) vs dense attention.
    ``kpos`` [T] carries absolute key positions (-1 = empty ring slot)."""
    S, T = q.shape[1], k.shape[1]
    cq = _pick_chunk(S, chunk) if chunk else 0
    ck = _pick_chunk(T, max(chunk, 1) * 2) if chunk else 0
    if cq and ck and S >= chunk and T > ck:
        return _attend_chunked(q, k, v, qpos, kpos, causal, window, softcap,
                               cq, ck, scale)
    kp = kpos[None, :]
    # -1, not T: under a mesh the keys may be sharded (a cache's seq_kv),
    # and a DTensor expands a sharded dim only to its own size
    mask = (kp >= 0)[:, None, :].expand(1, S, -1)
    if causal:
        mask = mask & (kp[:, None, :] <= qpos[..., None])
    if window:
        mask = mask & (kp[:, None, :] > qpos[..., None] - window)
    # [B, S, T] placed as the keys are (a cache's seq_kv)
    mask = shard(mask, "batch", None, "seq_kv")
    return _attend(q, k, v, mask, softcap, scale)


def _ring_write(buf, dim: int, idx, src) -> None:
    """``buf.index_copy_(dim, idx, src)`` for the contiguous slots ``idx``.
    On a ``DTensor`` (a cache under a mesh, sharded along ``dim`` by its
    ``seq_kv``), where ``index_copy_`` would re-place the buffer, the same
    write as a copy of the whole buffer when ``src`` fills it, or as a
    select over the slots when it holds one position."""
    if not is_dtensor(buf):
        buf.index_copy_(dim, idx, src)
        return
    n = src.shape[dim]
    if n == buf.shape[dim]:  # idx is 0..T-1
        buf.copy_(src)
    elif n == 1:
        hit = torch.arange(buf.shape[dim], device=idx.device) == idx
        hit = hit.view([-1 if d == dim else 1 for d in range(buf.dim())])
        buf.copy_(torch.where(hit, src, buf))
    else:
        raise ValueError(f"a cache under a mesh takes a write of one "
                         f"position or of all {buf.shape[dim]}, not {n}")


def _write_cache(cache: Dict, k, v, positions):
    """The JAX package's ring-buffer write, in place: S new keys at slot
    ``len % T`` (clamped so the run fits, as ``dynamic_update_slice``
    clamps), or the last T of them at slot 0 when S >= T."""
    T = cache["k"].shape[1]
    S = k.shape[1]
    if S >= T:
        k_w, v_w, pos_w = k[:, -T:], v[:, -T:], positions[0, -T:]
        start = torch.zeros((), dtype=torch.long, device=k.device)
    else:
        k_w, v_w, pos_w = k, v, positions[0]
        start = torch.clamp(cache["len"].long() % T, max=T - S)
    idx = start + torch.arange(k_w.shape[1], device=k.device)
    _ring_write(cache["k"], 1, idx, k_w.to(cache["k"].dtype))
    _ring_write(cache["v"], 1, idx, v_w.to(cache["v"].dtype))
    _ring_write(cache["pos"], 0, idx, pos_w.to(torch.int32))
    cache["len"].add_(S)


def attention_apply(params, cfg: ModelConfig, x, positions,
                    window: int = 0, cache: Optional[Dict] = None,
                    kv_source: Optional[torch.Tensor] = None,
                    fresh: bool = False, bidirectional: bool = False):
    """Returns (out, cache).  ``cache``: {"k","v","pos","len"}, written in
    place; ``kv_source``: cross-attention memory.  ``fresh``: the caller
    promises the queries are at positions 0..S-1 on every row and ``cache``
    (if any) is empty, as in the uncached forward with default positions and
    the serving engine's prefill.  ``bidirectional``: ``kv_source`` holds
    one key and value row per query, as whisper's encoder hands its
    block's input (the reference's full-visibility ``kv_source`` mask with
    no rotary); without a cache or softcap that is ``ops.attention`` with
    ``causal=False``.

    Self-attention over S > 1 fresh tokens without softcap goes through
    ``ops.attention`` (flash attention, GQA read in place): the queries'
    keys are exactly the S in-flight ones, and the slots of an empty cache
    beyond them are masked by ``pos = -1`` in the reference, so restricting
    attention to the in-flight keys with causal index masking computes the
    same function.  Every other case (decode against ring slots, softcap,
    cross-attention) takes the ported dense / chunked path."""
    B, S, D = x.shape
    h, kh, dh, dv = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.v_dim
    g = h // kh
    q = _mm(x, params["wq"].reshape(D, h * dh)).view(B, S, h, dh)
    src = x if kv_source is None else kv_source
    Ssrc = src.shape[1]
    k = _mm(src, params["wk"].reshape(D, kh * dh)).view(B, Ssrc, kh, dh)
    v = _mm(src, params["wv"].reshape(D, kh * dv)).view(B, Ssrc, kh, dv)
    if cfg.qk_norm:
        q = rmsnorm(params["qnorm"], q, cfg.norm_eps)
        k = rmsnorm(params["knorm"], k, cfg.norm_eps)
    if kv_source is None:  # self-attention: rotary on q & k
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    # the heads take the kv heads' placements, in whole groups of g (the
    # reference splits them into (kv head, group) to place them; a model
    # axis that shards the heads but not the kv heads cannot split them
    # in a view, forward or backward, under DTensor)
    q = shard(q, "batch", "seq", "kv_heads", None)
    k = shard(k, "batch", "seq_kv", "kv_heads", None)
    v = shard(v, "batch", "seq_kv", "kv_heads", None)

    T = cache["k"].shape[1] if cache is not None else S
    if cache is not None:
        _write_cache(cache, k, v, positions)
    if (bidirectional and cache is None and Ssrc == S
            and not cfg.logit_softcap and dv == dh):
        dt = torch.promote_types(q.dtype, v.dtype)
        out = ops.attention(q.to(dt).transpose(1, 2),
                            k.to(dt).transpose(1, 2),
                            v.to(dt).transpose(1, 2), causal=False)
        out = out.transpose(1, 2).to(v.dtype)
    elif (kv_source is None and fresh and S > 1 and not cfg.logit_softcap
            and dv == dh):
        # the reference attends over the cache (same keys, cast to its
        # dtype) when S < T, over the in-flight keys when S >= T
        kv_dt = cache["v"].dtype if cache is not None and S < T else v.dtype
        dt = torch.promote_types(q.dtype, kv_dt)
        out = ops.attention(q.to(dt).transpose(1, 2),
                            k.to(kv_dt).to(dt).transpose(1, 2),
                            v.to(kv_dt).to(dt).transpose(1, 2),
                            causal=True, window=window)
        out = out.transpose(1, 2).to(kv_dt)
    else:
        if cache is None:
            k_att, v_att = k, v
            kpos = torch.arange(Ssrc, device=x.device)
        elif S >= T:
            # prefill: attend over the full in-flight keys (queries at
            # early positions need keys the ring has already dropped)
            k_att, v_att, kpos = k, v, positions[0]
        else:
            k_att, v_att, kpos = cache["k"], cache["v"], cache["pos"]
        qg = q.reshape(B, S, kh, g, dh)
        if kv_source is not None:  # cross-attention: full visibility
            mask = torch.ones((1, S, k_att.shape[1]), dtype=torch.bool,
                              device=x.device)
            out = _attend(qg, k_att, v_att, mask, cfg.logit_softcap)
        else:
            out = _dispatch_attend(qg, k_att, v_att, positions, kpos,
                                   causal=True, window=window,
                                   softcap=cfg.logit_softcap,
                                   chunk=cfg.attn_chunk)
    out = _mm(out.reshape(B, S, h * dv), params["wo"].reshape(h * dv, D))
    return shard(out, "batch", "seq", None), cache


# ---------------------------------------------------------------------------
# MLA: multi-head latent attention (DeepSeek-V2)
# ---------------------------------------------------------------------------

def mla_init(gen, cfg: ModelConfig, dtype=torch.float32, device=None):
    d, h = cfg.d_model, cfg.n_heads
    dh, dv, r = cfg.head_dim, cfg.v_dim, cfg.rope_head_dim
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    p = {}
    if qr:
        p["wdq"] = _init(gen, (d, qr), ("embed", None), dtype=dtype,
                         device=device)
        p["q_norm"] = rmsnorm_init(qr, dtype, device)
        p["wuq"] = _init(gen, (qr, h, dh + r), (None, "heads", "head_dim"),
                         dtype=dtype, device=device)
    else:
        p["wuq"] = _init(gen, (d, h, dh + r), ("embed", "heads", "head_dim"),
                         dtype=dtype, device=device)
    p["wdkv"] = _init(gen, (d, kvr + r), ("embed", "kv_lora"), dtype=dtype,
                      device=device)
    p["kv_norm"] = rmsnorm_init(kvr, dtype, device)
    p["wukv"] = _init(gen, (kvr, h, dh + dv),
                      ("kv_lora", "heads", "head_dim"), dtype=dtype,
                      device=device)
    p["wo"] = _init(gen, (h, dv, d), ("heads", "head_dim", "embed"),
                    scale=1.0 / math.sqrt(h * dv), dtype=dtype, device=device)
    return p


def mla_apply(params, cfg: ModelConfig, x, positions,
              cache: Optional[Dict] = None, fresh: bool = False):
    """Latent attention; returns (out, cache).  ``cache``: {"ckv",
    "k_rope", "len"}, the compressed pair the reference caches, written in
    place at slot ``len`` (clamped so the run fits, as
    ``dynamic_update_slice`` clamps; no ring).  ``fresh`` as in
    :func:`attention_apply`.

    The shared rope key is folded into every head: one ``dh + r``-wide q/k
    head and a ``dv``-wide v head, scale ``1/sqrt(dh + r)``.  A fresh
    prefill of S > 1 tokens goes through ``ops.attention``: unpadded where
    the kernel is built for the pair of widths (deepseek's 192 and 128,
    ``flash_attention.WIDTH_PAIRS``), else with q and k zero-padded from
    ``dh + r`` and v from ``dv`` to the smallest one width the kernel is
    built for that covers both (32 at the smoke config's 24 and 16): zero
    columns add nothing to ``q . k``, and the output's padding columns are
    dropped.
    The empty cache slots the reference attends over lie at key positions
    past every query and are masked causally, so attending over the S
    in-flight keys is the same function.  Decode against a plain bf16
    cache at widths the latent kernel is built for (:func:`_latent_decode`)
    attends in latent space (:func:`_mla_decode_latent`).  Other decodes
    and a prefill into a non-empty cache expand the whole cache through
    ``wukv`` and take the reference's dense / chunked path, as the
    reference does."""
    B, S, D = x.shape
    h, dh, dv, r = cfg.n_heads, cfg.head_dim, cfg.v_dim, cfg.rope_head_dim
    kvr = cfg.kv_lora_rank
    # queries
    if cfg.q_lora_rank:
        cq = rmsnorm(params["q_norm"], _mm(x, params["wdq"]), cfg.norm_eps)
        wuq = params["wuq"]
        q = _mm(cq, wuq.reshape(wuq.shape[0], h * (dh + r)))
    else:
        q = _mm(x, params["wuq"].reshape(D, h * (dh + r)))
    q = q.view(B, S, h, dh + r)
    q = torch.cat([q[..., :dh], apply_rope(q[..., dh:], positions,
                                           cfg.rope_theta)], dim=-1)

    # compressed kv + shared rope key
    ckv_full = _mm(x, params["wdkv"])                        # [B,S,kvr+r]
    ckv = rmsnorm(params["kv_norm"], ckv_full[..., :kvr], cfg.norm_eps)
    k_rope = apply_rope(ckv_full[..., kvr:][:, :, None, :], positions,
                        cfg.rope_theta)                      # [B,S,1,r]
    if cache is not None:
        T = cache["ckv"].shape[1]
        start = torch.clamp(cache["len"].long(), max=T - S)
        idx = start + torch.arange(S, device=x.device)
        _ring_write(cache["ckv"], 1, idx, ckv.to(cache["ckv"].dtype))
        _ring_write(cache["k_rope"], 1, idx,
                    k_rope.to(cache["k_rope"].dtype))
        cache["len"].add_(S)
    wukv = params["wukv"].reshape(kvr, h * (dh + dv))
    scale = 1.0 / math.sqrt(dh + r)
    pair = (dh + r, dv)
    width = next((w for w in HEAD_DIMS if w >= max(pair)), 0)
    if pair in WIDTH_PAIRS:
        width = 0  # unpadded: the kernel takes the two widths as they are
    if fresh and S > 1 and (width or pair in WIDTH_PAIRS):
        if cache is not None:  # the reference expands the cache's dtype
            ckv = ckv.to(cache["ckv"].dtype)
            k_rope = k_rope.to(cache["k_rope"].dtype)
        kv = _mm(ckv, wukv).view(B, S, h, dh + dv)
        dt = torch.promote_types(q.dtype, kv.dtype)
        kf = torch.cat([kv[..., :dh].to(dt),
                        k_rope.to(dt).expand(B, S, h, r)], dim=-1)

        def heads(t, seq):  # [B, S, h, w] -> [B, h, S, width or w]
            t = shard(t, "batch", seq, "heads", None).to(dt)
            if width:
                t = _pad(t, (0, width - t.shape[-1]))
            return t.transpose(1, 2)

        out = ops.attention(heads(q, "seq"), heads(kf, "seq_kv"),
                            heads(kv[..., dh:], "seq_kv"), causal=True,
                            scale=scale)
        out = out[..., :dv].transpose(1, 2).to(kv.dtype)
    elif _latent_decode(cfg, cache, S):
        out = _mla_decode_latent(q, cache, params["wukv"], positions, dh,
                                 scale)
    else:
        if cache is not None:
            ckv, k_rope = cache["ckv"], cache["k_rope"]
        T = ckv.shape[1]
        with obs.span("mla.expand"):
            kv = _mm_rows(ckv, wukv).view(B, T, h, dh + dv)
            k_nope, v = kv[..., :dh], kv[..., dh:]
            dt = torch.promote_types(k_nope.dtype, k_rope.dtype)
            kf = torch.cat([k_nope.to(dt),
                            k_rope.to(dt).expand(B, T, h, r)], dim=-1)
        # the heads whole, as the keys expanded from the latent cache hold
        # them (on a mesh the cache's sequence takes the model axis)
        q = shard(q, "batch", "seq", None, None)
        with obs.span("mla.attend"):
            out = _dispatch_attend(q[:, :, :, None, :], kf, v, positions,
                                   torch.arange(T, device=x.device),
                                   causal=True, window=0, softcap=0.0,
                                   chunk=cfg.attn_chunk, scale=scale)
        out = out[:, :, :, 0, :]
    out = _mm(out.reshape(B, S, h * dv), params["wo"].reshape(h * dv, D))
    return shard(out, "batch", "seq", None), cache


def _latent_decode(cfg: ModelConfig, cache: Optional[Dict], S: int) -> bool:
    """Whether an MLA call attends in latent space: one query a row
    against a cache that is a plain (not sharded) bf16 tensor, at the
    (kv_lora_rank, rope_head_dim) widths the latent kernel is built for
    (``mla_decode.LATENT_WIDTHS``)."""
    return (S == 1 and cache is not None and not is_dtensor(cache["ckv"])
            and cache["ckv"].dtype == torch.bfloat16
            and (cfg.kv_lora_rank, cfg.rope_head_dim) in LATENT_WIDTHS)


def _mla_decode_latent(q, cache: Dict, wukv, positions, dh: int,
                       scale: float):
    """MLA decode without expanding the cache (the DeepSeek-V2 paper's
    weight absorption): q ``[B, 1, h, dh + r]`` -> ``[B, 1, h, dv]``, the
    function of the expansion path with its products reassociated.  Each
    head's ``W_UK[h]`` (``wukv[:, h, :dh]``) folds into its query, ``q_lat
    = q_nope W_UK[h]ᵀ``, in the cache's dtype; ``ops.mla_decode`` attends
    with ``[q_lat, q_rope]`` over ``[ckv, k_rope]`` and with the weights
    over ``ckv`` (scale ``1 / sqrt(dh + r)`` as before); ``W_UV[h]``
    (``wukv[:, h, dh:]``) then takes its output back to the head's
    width.  ``mla.expand`` spans the two products, ``mla.attend`` the
    attention."""
    obs.add("mla.latent_decode")
    dt = cache["ckv"].dtype
    w = wukv.to(dt)                                     # [kvr, h, dh + dv]
    B = q.shape[0]
    q = q[:, 0].to(dt)                                  # [B, h, dh + r]
    with obs.span("mla.expand"):
        q_lat = torch.matmul(q[..., :dh].transpose(0, 1),
                             w[..., :dh].permute(1, 2, 0))  # [h, B, kvr]
    with obs.span("mla.attend"):
        o = ops.mla_decode(q_lat.transpose(0, 1), q[..., dh:], cache["ckv"],
                           cache["k_rope"][:, :, 0],
                           positions.expand(B, 1)[:, 0].long(), scale)
    with obs.span("mla.expand"):
        out = torch.matmul(o.transpose(0, 1),
                           w[..., dh:].transpose(0, 1))     # [h, B, dv]
    return out.transpose(0, 1)[:, None]


# ---------------------------------------------------------------------------
# FFNs
# ---------------------------------------------------------------------------

def ffn_init(gen, d: int, dff: int, dtype=torch.float32, device=None):
    return {
        "wi": _init(gen, (d, dff), ("embed", "ff"), dtype=dtype,
                    device=device),
        "wg": _init(gen, (d, dff), ("embed", "ff"), dtype=dtype,
                    device=device),
        "wo": _init(gen, (dff, d), ("ff", "embed"), dtype=dtype,
                    device=device),
    }


def ffn_apply(params, x, act: str = "silu"):
    """SwiGLU through ``ops.swiglu`` over ``[-1, d]``; the GeLU variant
    (tanh approximation, as ``jax.nn.gelu``) in plain torch."""
    if act == "silu":
        dt = torch.promote_types(x.dtype, params["wg"].dtype)
        d = x.shape[-1]
        out = ops.swiglu(x.reshape(-1, d).to(dt).contiguous(),
                         params["wg"].to(dt), params["wi"].to(dt),
                         params["wo"].to(dt))
        return out.reshape(*x.shape[:-1], out.shape[-1])
    h = F.gelu(_mm(x, params["wg"]), approximate="tanh") * _mm(
        x, params["wi"])
    h = shard(h, "batch", "seq", "ff")
    return _mm(h, params["wo"])


# ---------------------------------------------------------------------------
# MoE: sort-based capacity dispatch
# ---------------------------------------------------------------------------

def moe_init(gen, cfg: ModelConfig, dtype=torch.float32, device=None):
    """The router is fp32 whatever ``dtype`` is, as in the reference."""
    d, e, dff = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    p = {
        "router": _init(gen, (d, e), ("embed", None), device=device),
        "wi": _init(gen, (e, d, dff), ("expert", "fsdp", "ff"), dtype=dtype,
                    device=device),
        "wg": _init(gen, (e, d, dff), ("expert", "fsdp", "ff"), dtype=dtype,
                    device=device),
        "wo": _init(gen, (e, dff, d), ("expert", "ff", "fsdp"), dtype=dtype,
                    device=device),
    }
    if cfg.n_shared_experts:
        p["shared"] = ffn_init(gen, d, dff * cfg.n_shared_experts, dtype,
                               device)
    return p


def _moe_route(x, router, cfg: ModelConfig):
    """The router and the dispatch of one batch of sequences: (buf ``[E,
    B*C, d]``, dest, w, ranks, me, ce); see :func:`moe_apply`."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = max(1, int(cfg.capacity_factor * k * S / E))
    BC = B * C

    logits = _mm(x.float(), router)                          # [B,S,E]
    gates = torch.softmax(logits, dim=-1)
    topv, topi = torch.topk(gates, k, dim=-1)                # [B,S,k]
    topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)

    # the aux loss's means (Switch-style load balancing)
    me = gates.mean(dim=(0, 1))                              # [E]
    ce = F.one_hot(topi, E).sum(dim=2).float().mean(dim=(0, 1))

    flat_e = topi.reshape(B, S * k)
    # stable, as jnp.argsort: the tie order decides who is dropped
    sort_idx = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, sort_idx)
    # rank within the expert's segment
    pos = torch.arange(S * k, device=x.device) - torch.searchsorted(
        sorted_e, sorted_e, side="left")
    keep = pos < C
    batch = torch.arange(B, device=x.device)[:, None]
    # slot of each choice in the expert-major buffer; overflow -> E*B*C
    dest = torch.where(keep, sorted_e * BC + batch * C + pos, E * BC)
    tok = sort_idx // k                                      # source tokens
    xs = torch.gather(x, 1, tok[..., None].expand(B, S * k, d))
    ws = torch.gather(topv.reshape(B, S * k), 1, sort_idx)

    buf = x.new_zeros((E * BC + 1, d)).index_add_(
        0, dest.reshape(-1), xs.reshape(-1, d))[:-1]
    ranks = torch.argsort(sort_idx, dim=-1).view(B, S, k).sort(-1).values
    return buf.view(E, BC, d), dest, ws * keep, ranks, me, ce


def _moe_combine(ye, dest, w, ranks, x_dtype):
    """Each token's k weighted expert outputs (``ye`` ``[E, B*C, d]``),
    summed in ``x_dtype`` in the order of their experts; see
    :func:`moe_apply`."""
    E, BC, d = ye.shape
    B, S, k = ranks.shape
    # a zero row for the dropped choices, as the reference pads
    y = torch.cat([ye.reshape(E * BC, d), ye.new_zeros((1, d))])
    yc = y[dest.reshape(-1)] * w.reshape(-1, 1).to(y.dtype)
    batch = torch.arange(B, device=ye.device)[:, None]
    yk = yc.to(x_dtype)[(batch[..., None] * (S * k) + ranks).reshape(-1)]
    yk = yk.view(B, S, k, d)
    out = yk[:, :, 0]
    for j in range(1, k):
        out = out + yk[:, :, j]
    return out


def _row_placements(x):
    """Under a mesh: a function from a tensor dim to the placements that
    shard it where ``shard(x, "batch", ...)`` shards the batch rows
    (``Replicate()`` on every other mesh dim), the placements that are
    ``Partial()`` on those mesh dims, and the number of row shards."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    rows = tuple(p == Shard(0) for p in shard(
        x, "batch", *([None] * (x.dim() - 1))).placements)
    n = 1
    for i, r in enumerate(rows):
        n *= x.device_mesh.size(i) if r else 1

    def on(dim):  # None: replicated on every mesh dim
        return tuple(Shard(dim) if r and dim is not None else Replicate()
                     for r in rows)

    return on, tuple(Partial() if r else Replicate() for r in rows), n


def _moe_route_dt(x, router, cfg: ModelConfig):
    """:func:`_moe_route` on each rank's own sequences: the buffer's rows
    and the index tensors sharded with the batch, the aux loss's means
    partial over the row shards (each shard's mean over its count)."""
    from torch.distributed.tensor.experimental import local_map

    on, part, n = _row_placements(x)

    def route(xl, rl):
        buf, dest, w, ranks, me, ce = _moe_route(xl, rl, cfg)
        return buf, dest, w, ranks, me / n, ce / n

    return local_map(route, out_placements=(on(1), on(0), on(0), on(0),
                                            part, part),
                     in_placements=(on(0), on(None)),
                     in_grad_placements=(on(0), part),
                     redistribute_inputs=True)(x, router)


def _moe_combine_dt(x, ye, dest, w, ranks):
    """:func:`_moe_combine` on each rank's own sequences."""
    from torch.distributed.tensor.experimental import local_map

    on, _, _ = _row_placements(x)
    dt = x.dtype
    pl = (on(1), on(0), on(0), on(0))
    return local_map(lambda *a: _moe_combine(*a, dt), out_placements=(on(0),),
                     in_placements=pl, in_grad_placements=pl,
                     redistribute_inputs=True)(ye, dest, w, ranks)


def moe_apply(params, cfg: ModelConfig, x, act: str = "silu"):
    """x: [B, S, d] -> (out [B, S, d], Switch aux loss, fp32 scalar).

    The reference's per-sequence capacity dispatch: each sequence gives
    every expert ``C`` slots; the ``k`` choices of its tokens, sorted
    stably by expert, take an expert's slots in token order, and those
    past ``C`` are dropped.  The slots are laid out expert-major,
    ``[E, B, C, d]``, so that each expert's ``B * C`` rows are one
    contiguous ``[B*C, d]`` block: with ``act="silu"`` each goes through
    ``ops.swiglu`` (B3 on a CUDA tensor), every expert every call, as the
    reference computes its dense buffer.  GeLU experts stay plain torch.
    The combine sums each token's choices in a fixed order, so that a run
    repeats its tokens bit for bit on any device.

    Under a mesh the routing and the combine run on each rank's own
    sequences (``local_map`` over the batch shards: the dispatch is per
    sequence), and the experts take the buffer as ``shard`` places it."""
    B, S, d = x.shape
    E = cfg.n_experts
    with obs.span("moe.route"):
        route = _moe_route_dt if is_dtensor(x) else _moe_route
        buf, dest, w, ranks, me, ce = route(x, params["router"], cfg)
    aux = E * torch.sum(me * ce) * cfg.router_aux_coef

    xe = shard(buf, "expert", "batch", None)
    with obs.span("moe.experts"):
        if act == "silu":
            dt = torch.promote_types(x.dtype, params["wg"].dtype)
            wg, wi, wo = (params[n].to(dt) for n in ("wg", "wi", "wo"))
            ye = ops.swiglu_experts(xe.to(dt), wg, wi, wo)
        else:
            h = F.gelu(_mm(xe, params["wg"]), approximate="tanh") * _mm(
                xe, params["wi"])
            h = shard(h, "expert", "batch", "ff")
            ye = _mm(h, params["wo"])
    ye = shard(ye, "expert", "batch", None)

    with obs.span("moe.combine"):
        if is_dtensor(x):
            out = _moe_combine_dt(x, ye, dest, w, ranks)
        else:
            out = _moe_combine(ye, dest, w, ranks, x.dtype)
    if cfg.n_shared_experts:
        out = out + ffn_apply(params["shared"], x, act)
    return shard(out, "batch", "seq", None), aux


# ---------------------------------------------------------------------------
# Mamba (selective SSM): jamba's mixer
# ---------------------------------------------------------------------------

def mamba_init(gen, cfg: ModelConfig, dtype=torch.float32, device=None):
    """``A_log`` is fp32 whatever ``dtype`` is, as in the reference."""
    d = cfg.d_model
    di = cfg.mamba_expand * d
    n = cfg.mamba_d_state
    dtr = max(1, math.ceil(d / 16))
    a_log = torch.log(torch.arange(1.0, n + 1.0, device=device)).repeat(di, 1)
    return {
        "in_proj": _init(gen, (d, 2 * di), ("embed", "mamba_inner"),
                         dtype=dtype, device=device),
        "conv_w": _init(gen, (cfg.mamba_d_conv, di), ("conv", "mamba_inner"),
                        scale=0.5, dtype=dtype, device=device),
        "conv_b": _zeros((di,), ("mamba_inner",), dtype, device),
        "x_proj": _init(gen, (di, dtr + 2 * n), ("mamba_inner", None),
                        dtype=dtype, device=device),
        "dt_proj": _init(gen, (dtr, di), (None, "mamba_inner"), dtype=dtype,
                         device=device),
        "dt_bias": _zeros((di,), ("mamba_inner",), dtype, device),
        "A_log": Param(a_log, ("mamba_inner", None)),
        "D": _ones((di,), ("mamba_inner",), dtype, device),
        "out_proj": _init(gen, (di, d), ("mamba_inner", "embed"),
                          dtype=dtype, device=device),
    }


def _causal_conv1d(u, w, b, state=None):
    """u: [B,S,di]; w: [K,di] depthwise; state: [B,K-1,di] (decode).
    Returns (out, new_state), new_state in ``u``'s dtype."""
    K, S = w.shape[0], u.shape[1]
    if state is not None:
        u_pad = torch.cat([state.to(u.dtype), u], dim=1)
    else:
        u_pad = _pad(u, (0, 0, K - 1, 0))
    out = u_pad[:, :S] * w[0]
    for i in range(1, K):
        out = out + u_pad[:, i: i + S] * w[i]
    return out + b, u_pad[:, -(K - 1):]


def _softplus(x):
    """``jax.nn.softplus`` (``logaddexp(x, 0)``): no threshold, unlike
    ``F.softplus``."""
    return x.clamp_min(0) + torch.log1p(torch.exp(-x.abs()))


def _mamba_scan_into(h, da, prev):
    """The recurrence ``h_t = da_t * h_{t-1} + h_t`` over dim 1 of ``h``
    ``[B,S,di,n]`` in place, from ``prev`` ``[B,di,n]`` (or none: zeros);
    returns the last state (a view into ``h``)."""
    hv, dv = h.unbind(1), da.unbind(1)  # the steps' views, made at once
    for t in range(len(hv)):
        if prev is not None:
            hv[t].addcmul_(dv[t], prev)
        prev = hv[t]
    return prev


class _MambaScan(torch.autograd.Function):
    """The scan under autograd, one in-place step a token both ways: the
    states written over a copy of the input, and in the backward the
    states' gradient ``G_t = g_t + da_{t+1} G_{t+1}`` run in reverse over
    a copy of the output gradient; then ``dx = G``, ``dda_t = G_t
    h_{t-1}``, ``dprev = da_0 G_0``."""

    @staticmethod
    def forward(ctx, x, da, prev):
        h = x.clone()
        _mamba_scan_into(h, da, prev)
        ctx.save_for_backward(da, h, prev)
        return h

    @staticmethod
    def backward(ctx, g):
        da, h, prev = ctx.saved_tensors
        G = g.clone()
        gv, dv = G.unbind(1), da.unbind(1)
        for t in range(len(gv) - 2, -1, -1):
            gv[t].addcmul_(dv[t + 1], gv[t + 1])
        dda = G.clone()
        dda[:, 1:].mul_(h[:, :-1])
        if prev is None:
            dda[:, 0].zero_()
            return G, dda, None
        dda[:, 0].mul_(prev)
        return G, dda, da[:, 0] * G[:, 0]


def _mamba_scan(hs, da, prev):
    """``h_t = da_t * h_{t-1} + hs_t`` over dim 1 of ``[B,S,di,n]`` from
    ``prev`` (``[B,di,n]``, or none: zeros): (the states, the last).
    Under autograd through :class:`_MambaScan`; otherwise each step's
    state is written over ``hs`` in place."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (hs, da, prev)):
        h = _MambaScan.apply(hs, da, prev)
        return h, h[:, -1]
    return hs, _mamba_scan_into(hs, da, prev)


def _mamba_scan_dt(hs, da, prev):
    """:func:`_mamba_scan` on ``DTensor``s, on each rank's own shards
    (``local_map``): the recurrence is elementwise in batch, ``di`` and
    ``n``, so those keep their placements; the time dim is gathered."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    pl = tuple(Replicate() if p.is_partial() or p == Shard(1) else p
               for p in hs.placements)
    last = tuple(Shard(p.dim - 1) if isinstance(p, Shard) and p.dim > 1
                 else p for p in pl)
    return local_map(_mamba_scan, out_placements=(pl, last),
                     in_placements=(pl, pl, None if prev is None else last),
                     in_grad_placements=(pl, pl, None if prev is None
                                         else last),
                     redistribute_inputs=True)(hs, da, prev)


def mamba_apply(params, cfg: ModelConfig, x, state: Optional[Dict] = None):
    """Returns (out, state); ``state`` = {"conv": [B,K-1,di], "ssm":
    [B,di,n] fp32}, written in place when given (a new dict otherwise).

    The scan is the reference's recurrence ``h = a * h + b`` run in time
    order from ``state["ssm"]`` (zeros without a state), for the cached and
    the uncached call alike (the reference's uncached call takes an
    associative scan of the same recurrence): one ``addcmul_`` a step,
    writing each step's state over ``b`` in place, so ``[B,S,di,n]`` fp32
    is held twice (``a`` and ``b``/the states), not three times."""
    B, S, d = x.shape
    di = cfg.mamba_expand * d
    n = cfg.mamba_d_state
    dtr = max(1, math.ceil(d / 16))

    uz = _mm(x, params["in_proj"])
    u, z = uz[..., :di], uz[..., di:]
    u, conv_state = _causal_conv1d(u, params["conv_w"], params["conv_b"],
                                   None if state is None else state["conv"])
    u = shard(F.silu(u), "batch", "seq", "mamba_inner")

    # summed whole before it is sliced, as mlstm_apply's products are
    xdbc = shard(_mm(u, params["x_proj"]), "batch", "seq", None)
    dt = _softplus(_mm(xdbc[..., :dtr], params["dt_proj"])
                   + params["dt_bias"]).float()
    Bc = xdbc[..., dtr: dtr + n].float()                     # [B,S,n]
    Cc = xdbc[..., dtr + n:].float()
    A = -torch.exp(params["A_log"].float())                  # [di,n]

    uf = u.float()
    da = (dt[..., None] * A).exp_()                          # [B,S,di,n]
    hs = (dt * uf)[..., None] * Bc[:, :, None, :]            # db, then h
    prev = None if state is None else state["ssm"].float()
    with obs.span("mamba.scan"):
        hs, prev = (_mamba_scan_dt if is_dtensor(hs) else _mamba_scan)(
            hs, da, prev)
    del da
    y = torch.einsum("bsdn,bsn->bsd", hs, Cc)
    y = y + uf * params["D"].float()
    y = y.to(x.dtype) * F.silu(z)
    out = shard(_mm(y, params["out_proj"]), "batch", "seq", None)
    if state is None:
        return out, {"conv": conv_state.to(x.dtype), "ssm": prev.clone()}
    state["conv"].copy_(conv_state)
    state["ssm"].copy_(prev)
    return out, state


# ---------------------------------------------------------------------------
# xLSTM: mLSTM (matrix memory, chunked parallel) + sLSTM (scalar, time loop)
# ---------------------------------------------------------------------------

def mlstm_init(gen, cfg: ModelConfig, dtype=torch.float32, device=None):
    d = cfg.d_model
    di = 2 * d
    return {
        "up": _init(gen, (d, 2 * di), ("embed", "lstm_inner"), dtype=dtype,
                    device=device),
        "conv_w": _init(gen, (4, di), ("conv", "lstm_inner"), scale=0.5,
                        dtype=dtype, device=device),
        "conv_b": _zeros((di,), ("lstm_inner",), dtype, device),
        "wq": _init(gen, (di, di), ("lstm_inner", None), dtype=dtype,
                    device=device),
        "wk": _init(gen, (di, di), ("lstm_inner", None), dtype=dtype,
                    device=device),
        "wv": _init(gen, (di, di), ("lstm_inner", None), dtype=dtype,
                    device=device),
        "wif": _init(gen, (di, 2 * cfg.n_heads), ("lstm_inner", None),
                     scale=0.01, dtype=dtype, device=device),
        "skip": _ones((di,), ("lstm_inner",), dtype, device),
        "down": _init(gen, (di, d), ("lstm_inner", "embed"), dtype=dtype,
                      device=device),
        "out_norm": rmsnorm_init(di, dtype, device),
    }


def mlstm_apply(params, cfg: ModelConfig, x, state: Optional[Dict] = None,
                chunk: int = 256):
    """Returns (out, state); ``state`` = {"C": [B,H,dh,dh] fp32, "N":
    [B,H,dh] fp32, "conv": [B,3,di]}, written in place when given (a new
    dict otherwise).

    S <= 4 takes the reference's unrolled recurrence, at prefill too;
    longer runs its chunked-parallel form seeded from the state, ``nc =
    max(1, S // chunk)`` chunks of ``S / nc`` steps, the scan over chunks a
    Python loop.  Where ``nc`` does not divide S the reference's reshape
    fails, and so does this (``ValueError``)."""
    B, S, d = x.shape
    H = cfg.n_heads
    di = 2 * d
    dh = di // H

    uz = _mm(x, params["up"])
    u, z = uz[..., :di], uz[..., di:]
    c, conv_state = _causal_conv1d(u, params["conv_w"], params["conv_b"],
                                   None if state is None else state["conv"])
    c = F.silu(c)

    # The products over the sharded inner dim are pending sums on a model
    # axis.  Each is summed whole here, as GSPMD places them: left
    # pending, the clamp and the chunk reshapes below would take them
    # sequence-sharded, and the [B, S, H, dh] split and the chunks cannot
    # carry that.
    def heads(t):  # [B,S,di] -> [B,H,S,dh]
        return shard(t, "batch", "seq", None).reshape(
            B, S, H, dh).transpose(1, 2)

    q = heads(_mm(c, params["wq"])).float()
    # scaled in the compute dtype, as the reference, before the fp32 cast
    k = (heads(_mm(c, params["wk"])) / math.sqrt(dh)).float()
    v = heads(_mm(u, params["wv"])).float()
    gates = shard(_mm(u, params["wif"]), "batch", "seq", None)  # [B,S,2H]
    logi = gates[..., :H].clamp(-12.0, 12.0).float().transpose(1, 2)
    logf = _elementwise(F.logsigmoid,
                        gates[..., H:].float() + 2.0).transpose(1, 2)

    if state is not None:
        C0, N0 = state["C"].float(), state["N"].float()
    else:
        C0 = x.new_zeros((B, H, dh, dh), dtype=torch.float32)
        N0 = x.new_zeros((B, H, dh), dtype=torch.float32)

    if S <= 4:  # the reference's unrolled recurrence
        ys = []
        for t in range(S):
            f_t = torch.exp(logf[:, :, t])[..., None, None]
            i_t = torch.exp(logi[:, :, t])[..., None, None]
            kv = k[:, :, t, :, None] * v[:, :, t, None, :]
            C0 = f_t * C0 + i_t * kv
            N0 = f_t[..., 0] * N0 + i_t[..., 0] * k[:, :, t]
            qt = q[:, :, t]
            num = torch.einsum("bhd,bhdv->bhv", qt, C0)
            den = torch.einsum("bhd,bhd->bh", qt, N0).abs()[..., None]
            ys.append(num / den.clamp_min(1.0))
        y = torch.stack(ys, dim=2)
        Cl, Nl = C0, N0
    else:  # chunked parallel, seeded from the state
        nc = max(1, S // chunk)
        cs = S // nc
        if nc * cs != S:
            raise ValueError(f"mlstm_apply: {S} steps do not split into "
                             f"{nc} chunks of {cs} (the reference's "
                             f"reshape fails there too)")
        qc = q.reshape(B, H, nc, cs, dh)
        kc = k.reshape(B, H, nc, cs, dh)
        vc = v.reshape(B, H, nc, cs, dh)
        lic = logi.reshape(B, H, nc, cs)
        # on each rank's shard: cumsum's gradient (flip) has no DTensor
        # rule in torch 2.11
        cum_f = _elementwise(lambda t: torch.cumsum(t, dim=-1),
                             logf.reshape(B, H, nc, cs), along={3})
        tot_f = cum_f[..., -1]

        # intra-chunk: D[i,j] = exp(cum_f_i - cum_f_j + logi_j), j <= i
        dmat = cum_f[..., :, None] - cum_f[..., None, :] + lic[..., None, :]
        tri = torch.ones((cs, cs), dtype=torch.bool, device=x.device).tril()
        dmat = torch.where(tri, dmat, float("-inf"))
        att = torch.einsum("bhnid,bhnjd->bhnij", qc, kc) * torch.exp(dmat)
        y_intra = torch.einsum("bhnij,bhnjd->bhnid", att, vc)
        den_intra = att.sum(-1)

        # inter-chunk state scan
        decay_in = torch.exp(tot_f[..., None] - cum_f + lic)  # [B,H,n,cs]
        kv_chunk = torch.einsum("bhncd,bhncv,bhnc->bhndv", kc, vc, decay_in)
        n_chunk = torch.einsum("bhncd,bhnc->bhnd", kc, decay_in)
        Cs, Ns = [], []
        Cl, Nl = C0, N0
        for i in range(nc):
            Cs.append(Cl)
            Ns.append(Nl)
            decay = torch.exp(tot_f[:, :, i])
            Cl = decay[..., None, None] * Cl + kv_chunk[:, :, i]
            Nl = decay[..., None] * Nl + n_chunk[:, :, i]
        Cs_ = torch.stack(Cs, dim=2)                          # [B,H,n,dh,dh]
        Ns_ = torch.stack(Ns, dim=2)
        qdec = qc * torch.exp(cum_f)[..., None]
        y_inter = torch.einsum("bhncd,bhndv->bhncv", qdec, Cs_)
        den_inter = torch.einsum("bhncd,bhnd->bhnc", qdec, Ns_)

        num = y_intra + y_inter
        den = (den_intra + den_inter).abs()[..., None]        # |q . n|
        y = (num / den.clamp_min(1.0)).reshape(B, H, S, dh)

    # whole rows for the norm: the einsums may leave the sequence sharded
    # on a model axis, which the norm's [B*S, di] rows cannot carry
    y = shard(y.transpose(1, 2).reshape(B, S, di).to(x.dtype), "batch",
              "seq", None)
    y = rmsnorm(params["out_norm"], y, cfg.norm_eps)
    y = y + params["skip"] * c                                # learnable skip
    y = y * F.silu(z)
    out = shard(_mm(y, params["down"]), "batch", "seq", None)
    if state is None:
        return out, {"C": Cl, "N": Nl, "conv": conv_state}
    state["C"].copy_(Cl)
    state["N"].copy_(Nl)
    state["conv"].copy_(conv_state)
    return out, state


def slstm_init(gen, cfg: ModelConfig, dtype=torch.float32, device=None):
    d = cfg.d_model
    H = cfg.n_heads
    dh = d // H
    dff = max(128, ((int(d * 4 / 3) + 127) // 128) * 128)  # 4/3 GLU
    return {
        "win": _init(gen, (d, 4 * d), ("embed", "lstm_inner"), dtype=dtype,
                     device=device),
        "rrec": _init(gen, (H, dh, 4 * dh), (None, None, None),
                      scale=1.0 / math.sqrt(dh), dtype=dtype, device=device),
        "bias": _zeros((4 * d,), ("lstm_inner",), dtype, device),
        "out_norm": rmsnorm_init(d, dtype, device),
        "up": _init(gen, (d, 2 * dff), ("embed", "ff"), dtype=dtype,
                    device=device),
        "down": _init(gen, (dff, d), ("ff", "embed"), dtype=dtype,
                      device=device),
    }


def _slstm_cell(c, n, m, pre):
    """One stabilized sLSTM step (pre = Wx_t + h_{t-1} R already formed)."""
    zi, ii, fi, oi = pre.chunk(4, dim=-1)
    zt = torch.tanh(zi)
    ot = torch.sigmoid(oi)
    log_f = F.logsigmoid(fi)
    m_new = torch.maximum(log_f + m, ii)
    i_p = torch.exp(ii - m_new)
    f_p = torch.exp(log_f + m - m_new)
    c_new = f_p * c + i_p * zt
    n_new = f_p * n + i_p
    h_new = ot * c_new / n_new.clamp_min(1e-6)
    return c_new, n_new, m_new, h_new


def slstm_initial_state(batch: int, heads: int, dh: int, device=None):
    """The reference's initial sLSTM state: c = h = 0, n = 1e-6, m = -10,
    four distinct fp32 tensors ``[batch, heads, dh]``."""
    def full(v):
        return torch.full((batch, heads, dh), v, dtype=torch.float32,
                          device=device)
    return {"c": full(0.0), "n": full(1e-6), "h": full(0.0),
            "m": full(-10.0)}


def _heads_mm(x, w):
    """``einsum("bhd,hdk->bhk", x, w)`` as one batched product over the
    heads."""
    return torch.bmm(x.transpose(0, 1), w).transpose(0, 1)


def _slstm_cell_backward(c, n, m, pre, gc, gn, gm, gh):
    """(dc, dn, dm, dpre) of :func:`_slstm_cell` at (c, n, m, pre) for the
    cotangents of its (c, n, m, h): the step's forward recomputed, then
    each op's derivative as autograd takes it (``maximum`` splits a tie
    in half, ``clamp_min`` passes where it did not clamp)."""
    zi, ii, fi, oi = pre.chunk(4, dim=-1)
    zt = torch.tanh(zi)
    ot = torch.sigmoid(oi)
    log_f, buf = torch.ops.aten.log_sigmoid_forward(fi)
    a = log_f + m
    m_new = torch.maximum(a, ii)
    i_p = torch.exp(ii - m_new)
    f_p = torch.exp(a - m_new)
    c_new = f_p * c + i_p * zt
    n_new = f_p * n + i_p
    nc = n_new.clamp_min(1e-6)
    g_q = gh / nc                                  # h = (ot * c_new) / nc
    g_nc = -gh * ((ot * c_new) / nc) / nc
    g_c = gc + g_q * ot
    g_n = gn + torch.where(n_new >= 1e-6, g_nc, 0.0)
    e_i = (g_c * zt + g_n) * i_p                   # through exp(ii - m_new)
    e_f = (g_c * c + g_n * n) * f_p                # through exp(a - m_new)
    g_m = gm - e_i - e_f
    g_max = torch.where(a == ii, g_m / 2, g_m)
    g_a = e_f + g_max.masked_fill(a < ii, 0.0)
    dpre = torch.cat([torch.ops.aten.tanh_backward(g_c * i_p, zt),
                      e_i + g_max.masked_fill(a > ii, 0.0),
                      torch.ops.aten.log_sigmoid_backward(g_a, fi, buf),
                      torch.ops.aten.sigmoid_backward(g_q * c_new, ot)],
                     dim=-1)
    return g_c * f_p, g_n * f_p, g_a, dpre


def _slstm_loop(wx, rrec, c, n, h, m, keep: bool = False):
    """The time loop over ``wx`` ``[B,S,H,4dh]`` from state (c, n, h, m):
    the per-step h's, the final state, and with ``keep`` each step's
    (c, n, m, h) before it and its ``pre``."""
    hs, kept = [], []
    for wx_t in wx.unbind(1):
        pre = wx_t + _heads_mm(h, rrec)
        if keep:
            kept.append((c, n, m, h, pre))
        c, n, m, h = _slstm_cell(c, n, m, pre)
        hs.append(h)
    return hs, (c, n, h, m), kept


class _SLSTMScan(torch.autograd.Function):
    """The reference's ``_slstm_scan`` custom VJP: the reverse loop only
    carries the state cotangents and emits each step's ``dpre``
    (:func:`_slstm_cell_backward`, a step's derivative in closed form);
    the recurrent weight's gradient is one contraction over (batch, time)
    afterwards."""

    @staticmethod
    def forward(ctx, wx, rrec, c0, n0, h0, m0):
        hs, final, kept = _slstm_loop(wx, rrec, c0, n0, h0, m0, keep=True)
        ctx.save_for_backward(rrec, *(torch.stack(col) for col in
                                      zip(*kept)))
        return (torch.stack(hs), *final)

    @staticmethod
    def backward(ctx, dhs, dc, dn, dh, dm):
        rrec, c_prev, n_prev, m_prev, h_prev, pres = ctx.saved_tensors
        steps = list(zip(c_prev.unbind(0), n_prev.unbind(0),
                         m_prev.unbind(0), pres.unbind(0), dhs.unbind(0)))
        rrec_t = rrec.transpose(1, 2)
        dpres = [None] * len(steps)
        for t in reversed(range(len(steps))):
            c, n, m, pre, dh_t = steps[t]
            dc, dn, dm, dpre = _slstm_cell_backward(c, n, m, pre, dc, dn,
                                                    dm, dh + dh_t)
            dh = _heads_mm(dpre, rrec_t)
            dpres[t] = dpre
        dpres = torch.stack(dpres)
        drrec = torch.einsum("sbhd,sbhk->hdk", h_prev, dpres)
        return dpres.transpose(0, 1), drrec, dc, dn, dh, dm


def _slstm_stacked(wx, rrec, c0, n0, h0, m0):
    """:func:`_slstm_loop` as (hs ``[S,B,H,dh]``, c, n, h, m)."""
    hs, final, _ = _slstm_loop(wx, rrec, c0, n0, h0, m0)
    return (torch.stack(hs), *final)


def slstm_scan(wx, rrec, c0, n0, h0, m0):
    """The reference's ``_slstm_scan``: wx ``[B,S,H,4dh]``, rrec
    ``[H,dh,4dh]``, states ``[B,H,dh]`` -> (hs ``[S,B,H,dh]``, (c, n, h,
    m)), differentiable through :class:`_SLSTMScan` while grad is enabled
    and an input requires it (else the plain loop).  On a ``DTensor`` wx
    each rank scans its own sequences (``local_map`` over the batch
    shards; the recurrent weight replicated, its gradient partial)."""
    fn = (_SLSTMScan.apply if torch.is_grad_enabled()
          and (wx.requires_grad or rrec.requires_grad) else _slstm_stacked)
    if not is_dtensor(wx):
        hs, *final = fn(wx, rrec, c0, n0, h0, m0)
        return hs, tuple(final)
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = wx.device_mesh
    rep = [Replicate()] * mesh.ndim
    c0, n0, h0, m0 = (t if isinstance(t, DTensor) else
                      DTensor.from_local(t, mesh, rep, run_check=False)
                      for t in (c0, n0, h0, m0))
    on, part, _ = _row_placements(wx)
    b = on(0)
    out = local_map(lambda *a: fn(*a),
                    out_placements=(on(1), b, b, b, b),
                    in_placements=(b, on(None), b, b, b, b),
                    in_grad_placements=(b, part, b, b, b, b),
                    redistribute_inputs=True)(wx, rrec, c0, n0, h0, m0)
    return out[0], tuple(out[1:])


def slstm_apply(params, cfg: ModelConfig, x, state: Optional[Dict] = None):
    """Sequential scalar-memory LSTM with per-head recurrence + GLU out;
    returns (out, state).  ``state`` = {"c","n","h","m"}, each [B,H,dh]
    fp32, written in place when given (a new dict otherwise).  The
    reference's ``lax.scan`` over time is a Python loop, one step a
    token, run by :func:`slstm_scan` (under autograd, its Function)."""
    B, S, d = x.shape
    H = cfg.n_heads
    dh = d // H
    wx = (_mm(x, params["win"]) + params["bias"]).float()
    # the gate dim whole before it splits into (head, gate): a model axis
    # that shards the 4d gate columns does not divide the heads
    wx = shard(wx, "batch", "seq", None).reshape(B, S, H, 4 * dh)

    st = slstm_initial_state(B, H, dh, x.device) if state is None else state
    c, n, h, m = (st[key].float() for key in ("c", "n", "h", "m"))
    rrec = params["rrec"].float()
    hs, (c, n, h, m) = slstm_scan(wx, rrec, c, n, h, m)
    y = hs.transpose(0, 1).reshape(B, S, d).to(x.dtype)
    y = rmsnorm(params["out_norm"], y, cfg.norm_eps)
    up = _mm(y, params["up"])
    dff = params["down"].shape[0]
    y = F.gelu(up[..., :dff], approximate="tanh") * up[..., dff:]
    out = shard(_mm(y, params["down"]), "batch", "seq", None)
    if state is None:
        return out, {"c": c, "n": n, "h": h, "m": m}
    for key, val in (("c", c), ("n", n), ("h", h), ("m", m)):
        state[key].copy_(val)
    return out, state
