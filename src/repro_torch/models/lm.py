"""The LM drivers: ``lm_init``, ``lm_apply`` (decoder-only),
``encdec_apply`` (whisper's encoder-decoder), ``lm_loss``, ``init_caches``
and ``cache_axes``, ported from the JAX package's ``repro.models.lm``.

The parameter and cache trees keep the JAX key paths (``embed``,
``final_norm``, ``head``, ``pre/q*``, ``scan/p*`` stacked with a leading
layers dim, ``rest/r*``; whisper's ``encoder``, ``enc_norm`` and
``dec_cross``, stacked), so ``jax.tree_util.keystr`` names map one to one
(:func:`repro_torch.bridge.lm_params_from_reference`).  The reference's
``lax.scan`` over the repeating period is a Python loop over the stacked
leading dim; where it rematerializes each period (``cfg.remat``), the port
wraps each period in ``torch.utils.checkpoint`` while grad is enabled.
"""

from __future__ import annotations

import math
from contextlib import nullcontext
from typing import Any, Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.parallel.sharding import (current_mesh, current_rules,
                                           mesh_context, shard)

from .blocks import (
    block_apply,
    block_init,
    cache_axes_for_block,
    init_cache_for_block,
)
from .config import ModelConfig
from .layers import (
    Param,
    _init,
    _mm,
    attention_apply,
    attention_init,
    rmsnorm,
    rmsnorm_init,
    tree_cast,
    tree_map,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name (``"bfloat16"``, ...)."""
    return _DTYPES[name]


def _unstack(tree) -> List[Any]:
    """A stacked value tree (leading layers dim) as one tree per layer,
    through ``unbind``: views, whose gradients autograd stacks once (a
    per-layer ``v[r]`` would fill a zero tensor of the whole stack for
    each layer's gradient)."""
    parts: List[Any] = []
    leaves = {}

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        leaves[path] = node.unbind(0)
        return path

    skeleton = walk(tree, ())
    n = len(next(iter(leaves.values()))) if leaves else 0
    for r in range(n):
        parts.append(tree_map(lambda path: leaves[path][r], skeleton,
                              is_leaf=lambda x: isinstance(x, tuple)))
    return parts


def _stack_params(trees: List[Any]):
    def stack(path_trees):
        first = path_trees[0]
        if isinstance(first, Param):
            return Param(torch.stack([t.value for t in path_trees]),
                         ("layers",) + first.axes)
        return {k: stack([t[k] for t in path_trees]) for k in first}
    return stack(trees)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def lm_init(cfg: ModelConfig, generator: torch.Generator, device=None):
    """A tree of :class:`Param` drawn from ``generator`` with the JAX
    package's distributions (its bits differ: compare through the bridge).
    Values are made on the generator's device and moved to ``device``."""
    dtype = torch_dtype(cfg.param_dtype)
    gen, dev = generator, device
    specs = cfg.block_specs()
    pre, p, reps, rem = cfg.layout()

    params: Dict[str, Any] = {
        "embed": _init(gen, (cfg.vocab, cfg.d_model), ("vocab", "embed"),
                       scale=1.0, dtype=dtype, device=dev),
        "final_norm": rmsnorm_init(cfg.d_model, dtype, dev),
    }
    if not cfg.tie_embeddings:
        params["head"] = _init(gen, (cfg.d_model, cfg.vocab),
                               ("embed", "vocab"), dtype=dtype, device=dev)
    if cfg.frontend != "none":
        # modality frontend stub: a projection of precomputed embeddings
        params["frontend_proj"] = _init(
            gen, (cfg.d_model, cfg.d_model), ("embed", None), dtype=dtype,
            device=dev)
    if cfg.is_encdec:
        params["encoder"] = _stack_params([
            block_init(gen, cfg, specs[0], dtype, dev)
            for _ in range(cfg.n_enc_layers)])
        params["enc_norm"] = rmsnorm_init(cfg.d_model, dtype, dev)
        params["dec_cross"] = _stack_params([
            _cross_block_init(gen, cfg, dtype, dev)
            for _ in range(cfg.n_layers)])
    params["pre"] = {f"q{j}": block_init(gen, cfg, specs[j], dtype, dev)
                     for j in range(pre)}
    params["scan"] = {
        f"p{pos}": _stack_params([
            block_init(gen, cfg, specs[pre + r * p + pos], dtype, dev)
            for r in range(reps)])
        for pos in range(p)}
    params["rest"] = {
        f"r{j}": block_init(gen, cfg, specs[pre + reps * p + j], dtype, dev)
        for j in range(rem)}
    return params


def _cross_block_init(gen, cfg: ModelConfig, dtype, device=None):
    return {"norm": rmsnorm_init(cfg.d_model, dtype, device),
            "attn": attention_init(gen, cfg, dtype, device)}


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------

def remat_active(cfg: ModelConfig, values) -> bool:
    """Whether :func:`lm_apply` rematerializes its scanned periods: for
    ``remat`` "full" or "dots" (the reference's ``jax.checkpoint``, with or
    without saving its products; the port recomputes the whole period for
    both), while grad is enabled and a scanned parameter requires it."""
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(cfg.remat)
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return False
    live = []
    tree_map(lambda t: live.append(t.requires_grad), values["scan"])
    return any(live)


def lm_apply(
    values,
    cfg: ModelConfig,
    tokens: torch.Tensor,                    # [B, S_text]
    positions: Optional[torch.Tensor] = None,
    extra_embeds: Optional[torch.Tensor] = None,  # [B, S_img, d] frontend stub
    caches: Optional[Dict] = None,
    logits_dtype=torch.float32,
    *,
    prefill: bool = False,
    last_only: bool = False,
):
    """Returns (logits [B,S,V], caches, aux_loss); ``aux_loss`` is the sum
    of the MoE layers' aux losses, an fp32 scalar on ``tokens``' device.

    ``caches`` (attention rings, MLA's latent cache, Mamba, mLSTM and sLSTM
    states) are written in place and returned.  ``prefill=True`` says the
    caches are empty (the recurrent states hold their initial values) and
    the tokens sit at positions 0..S-1 (then
    ``positions`` must be None); with it, or with neither caches nor
    positions, attention over S > 1 tokens may take the flash-attention
    kernel (:func:`repro_torch.models.layers.attention_apply`,
    :func:`repro_torch.models.layers.mla_apply`).
    ``last_only=True`` computes the final norm and the head on the last
    position only (logits ``[B, 1, V]``, the same values as the last row of
    the full logits).  Where :func:`remat_active`, each scanned period of
    the uncached forward runs under ``torch.utils.checkpoint`` (its kernels
    launch again in the backward's recompute)."""
    if cfg.is_encdec:
        raise ValueError(f"{cfg.name} is an encoder-decoder: use "
                         f"encdec_apply")
    if prefill and positions is not None:
        raise ValueError("prefill=True means positions 0..S-1: pass "
                         "positions=None")
    cdtype = torch_dtype(cfg.compute_dtype)
    specs = cfg.block_specs()
    pre, p, reps, rem = cfg.layout()

    x = values["embed"][tokens].to(cdtype)
    if cfg.name.startswith("gemma"):
        # the reference multiplies by sqrt(d) rounded to the compute dtype
        x = x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=cdtype))
    if extra_embeds is not None:
        pe = _mm(extra_embeds.to(cdtype), values["frontend_proj"].to(cdtype))
        x = torch.cat([pe, x], dim=1)
    B, S, _ = x.shape
    x = shard(x, "batch", "seq", None)
    fresh = prefill or (positions is None and caches is None)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :].expand(B, S)

    # the reference's aux sum: an fp32 scalar on the device
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)

    def layer(vals, li, cache):
        # the cache (or recurrent state) is written in place: the scanned
        # layers' caches are views into the stacked tensors
        nonlocal x, aux_total
        x, _, a = block_apply(tree_cast(vals, cdtype), cfg, specs[li], x,
                              positions, cache=cache, fresh=fresh)
        if a is not None:
            aux_total = aux_total + a

    for j in range(pre):
        layer(values["pre"][f"q{j}"], j,
              None if caches is None else caches["pre"][f"q{j}"])
    scan = {f"p{pos}": _unstack(values["scan"][f"p{pos}"])
            for pos in range(p)} if reps else {}

    def period(x, r):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for pos in range(p):
            vals = scan[f"p{pos}"][r]
            x, _, a = block_apply(tree_cast(vals, cdtype), cfg,
                                  specs[pre + r * p + pos], x, positions,
                                  fresh=fresh)
            if a is not None:
                aux = aux + a
        return x, aux

    remat = caches is None and remat_active(cfg, values)
    # the recompute runs where autograd runs the backward, on a CUDA
    # device's own thread for card tensors: the mesh and rules current
    # here (thread-local) go with it, or its shard(...) calls would place
    # nothing and it would not compute what the forward did
    scope = (current_mesh(), current_rules())

    def recompute_context():
        return nullcontext(), mesh_context(*scope)

    for r in range(reps):
        if caches is None:
            x, a = (checkpoint(period, x, r, use_reentrant=False,
                               context_fn=recompute_context) if remat
                    else period(x, r))
            aux_total = aux_total + a
            continue
        for pos in range(p):
            cache = tree_map(lambda c: c[r], caches["scan"][f"p{pos}"])
            layer(scan[f"p{pos}"][r], pre + r * p + pos, cache)
    for j in range(rem):
        layer(values["rest"][f"r{j}"], pre + reps * p + j,
              None if caches is None else caches["rest"][f"r{j}"])

    if last_only:
        x = x[:, -1:]
    x = rmsnorm(values["final_norm"], x, cfg.norm_eps)
    head = values["embed"].T if cfg.tie_embeddings else values["head"]
    logits = _mm(x, head.to(cdtype))
    if cfg.logit_softcap:
        cap = cfg.logit_softcap
        logits = cap * torch.tanh(logits / cap)
    logits = shard(logits.to(logits_dtype), "batch", "seq", "vocab")
    return logits, caches, aux_total


# ---------------------------------------------------------------------------
# whisper-style enc-dec
# ---------------------------------------------------------------------------

def encdec_apply(
    values,
    cfg: ModelConfig,
    frames: torch.Tensor,                    # [B, S_enc, d] precomputed (stub)
    tokens: torch.Tensor,                    # [B, S_dec]
    positions: Optional[torch.Tensor] = None,
    caches: Optional[Dict] = None,
    enc_out: Optional[torch.Tensor] = None,  # reused from the first step
    logits_dtype=torch.float32,
):
    """Returns (logits, caches, enc_out, aux), aux an fp32 zero.

    The encoder (when ``enc_out`` is None): ``frontend_proj`` over the
    frames, ``n_enc_layers`` blocks whose attention sees every frame (the
    reference passes each block's input as ``kv_source``: keys and values
    from the block's input, queries from its norm, no rotary; through
    ``ops.attention`` with ``causal=False``), then ``enc_norm``.  The
    decoder: per layer the self-attention block of ``scan/p0`` (cached
    when ``caches`` is given, written in place), then cross-attention over
    ``enc_out`` under ``dec_cross`` (the plain dense path: queries and
    memory differ in length).  The head is ``embed`` transposed when the
    embeddings are tied."""
    cdtype = torch_dtype(cfg.compute_dtype)
    spec = cfg.block_specs()[0]
    B = tokens.shape[0]

    if enc_out is None:
        h = _mm(frames.to(cdtype), values["frontend_proj"].to(cdtype))
        h = shard(h, "batch", "seq", None)
        epos = torch.arange(h.shape[1], device=h.device)[None, :].expand(
            B, h.shape[1])
        for vals in _unstack(values["encoder"]):
            h, _, _ = block_apply(tree_cast(vals, cdtype), cfg, spec, h,
                                  epos, kv_source=h, bidirectional=True)
        enc_out = rmsnorm(values["enc_norm"], h, cfg.norm_eps)

    x = values["embed"][tokens].to(cdtype)
    S = x.shape[1]
    fresh = positions is None and caches is None
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    x = shard(x, "batch", "seq", None)
    layers = zip(_unstack(values["scan"]["p0"]),
                 _unstack(values["dec_cross"]))
    for li, (vals, cross) in enumerate(layers):
        cross = tree_cast(cross, cdtype)
        cache = None if caches is None else tree_map(
            lambda c: c[li], caches["scan"]["p0"])
        x, _, _ = block_apply(tree_cast(vals, cdtype), cfg, spec, x,
                              positions, cache=cache, fresh=fresh)
        hh = rmsnorm(cross["norm"], x, cfg.norm_eps)
        co, _ = attention_apply(cross["attn"], cfg, hh, positions,
                                kv_source=enc_out)
        x = x + co

    x = rmsnorm(values["final_norm"], x, cfg.norm_eps)
    head = values["embed"].T if cfg.tie_embeddings else values["head"]
    logits = shard(_mm(x, head.to(cdtype)).to(logits_dtype), "batch", "seq",
                   "vocab")
    return (logits, caches, enc_out,
            torch.zeros((), dtype=torch.float32, device=x.device))


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def lm_loss(values, cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    """Next-token cross entropy over ``loss_mask``, plus the z-loss ``1e-4
    · mean(logz² · mask)`` over all positions, plus the MoE aux loss.
    ``batch``: tokens ``[B, S]``, loss_mask ``[B, S]``, optional
    extra_embeds (frontend stub; its prepended positions carry no loss),
    and whisper's frames.  Returns (total, {"loss", "aux",
    "ppl_proxy"})."""
    extra = batch.get("extra_embeds")
    if cfg.is_encdec:
        logits, _, _, aux = encdec_apply(values, cfg, batch["frames"],
                                         batch["tokens"])
    else:
        logits, _, aux = lm_apply(values, cfg, batch["tokens"],
                                  extra_embeds=extra)
        if extra is not None:
            logits = logits[:, extra.shape[1]:, :]
    tgt = batch["tokens"][:, 1:].long()
    # under a mesh the vocab is gathered for the gather of the gold logit
    # (the one collective the loss adds; a no-op without a mesh)
    lgt = shard(logits[:, :-1, :].float(), "batch", "seq", None)
    mask = batch["loss_mask"][:, 1:].float()
    logz = torch.logsumexp(lgt, dim=-1)
    gold = torch.gather(lgt, -1, tgt[..., None])[..., 0]
    nll = (logz - gold) * mask
    # each term summed whole under a mesh (a no-op without one): a
    # pending sum and a pending mean do not add (DTensor refuses the
    # redistribution between them in some torch releases)
    loss = shard(nll.sum() / mask.sum().clamp_min(1.0))
    # z-loss stabilizer (PaLM): keeps logsumexp near 0
    zloss = shard(1e-4 * torch.mean(torch.square(logz) * mask))
    return loss + zloss + aux, {
        "loss": loss, "aux": aux,
        "ppl_proxy": torch.exp(torch.clamp(loss, max=20.0))}


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, device=None):
    specs = cfg.block_specs()
    pre, p, reps, rem = cfg.layout()

    def stacked(pos):
        one = init_cache_for_block(cfg, specs[pre + pos], batch, max_len,
                                   dtype, device)
        return tree_map(lambda v: v.expand((reps,) + v.shape).clone(), one)

    return {
        "pre": {f"q{j}": init_cache_for_block(cfg, specs[j], batch, max_len,
                                              dtype, device)
                for j in range(pre)},
        "scan": ({f"p{pos}": stacked(pos) for pos in range(p)}
                 if reps else {}),
        "rest": {f"r{j}": init_cache_for_block(
            cfg, specs[pre + reps * p + j], batch, max_len, dtype, device)
            for j in range(rem)},
    }


def cache_axes(cfg: ModelConfig):
    """Logical-axes tree parallel to init_caches (scan adds a layers dim)."""
    specs = cfg.block_specs()
    pre, p, reps, rem = cfg.layout()

    def is_axes(x):
        return isinstance(x, tuple)

    def stacked(pos):
        return tree_map(lambda ax: ("layers",) + tuple(ax),
                        cache_axes_for_block(cfg, specs[pre + pos]),
                        is_leaf=is_axes)

    return {
        "pre": {f"q{j}": cache_axes_for_block(cfg, specs[j])
                for j in range(pre)},
        "scan": ({f"p{pos}": stacked(pos) for pos in range(p)}
                 if reps else {}),
        "rest": {f"r{j}": cache_axes_for_block(cfg, specs[pre + reps * p + j])
                 for j in range(rem)},
    }
