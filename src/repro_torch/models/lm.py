"""The decoder-only LM driver: ``lm_init``, ``lm_apply``, ``init_caches``
and ``cache_axes``, ported from the JAX package's ``repro.models.lm``.

The parameter and cache trees keep the JAX key paths (``embed``,
``final_norm``, ``head``, ``pre/q*``, ``scan/p*`` stacked with a leading
layers dim, ``rest/r*``), so ``jax.tree_util.keystr`` names map one to one
(:func:`repro_torch.bridge.lm_params_from_reference`).  The reference's
``lax.scan`` over the repeating period is a Python loop over the stacked
leading dim.  The encoder-decoder driver and the loss wait for later
slices (ROADMAP A4, A5).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch

from .blocks import (
    block_apply,
    block_init,
    cache_axes_for_block,
    check_supported,
    init_cache_for_block,
)
from .config import ModelConfig
from .layers import (
    Param,
    _init,
    _mm,
    not_ported,
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


def check_decoder(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` naming the ROADMAP item for a config
    the port cannot run yet (enc-dec, or a block kind it lacks)."""
    if cfg.is_encdec:
        raise not_ported(f"the encoder-decoder LM ({cfg.name})", "A4")
    for spec in set(cfg.block_specs()):
        check_supported(spec)


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
    check_decoder(cfg)
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


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------

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

    ``caches`` (attention rings and Mamba states) are written in place and
    returned.  ``prefill=True`` says the caches are empty (Mamba starts
    from the zero state) and the tokens sit at positions 0..S-1 (then
    ``positions`` must be None); with it, or with neither caches nor
    positions, attention over S > 1 tokens may take the flash-attention
    kernel (:func:`repro_torch.models.layers.attention_apply`).
    ``last_only=True`` computes the final norm and the head on the last
    position only (logits ``[B, 1, V]``, the same values as the last row of
    the full logits)."""
    check_decoder(cfg)
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
    fresh = prefill or (positions is None and caches is None)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :].expand(B, S)

    # the reference's aux sum: an fp32 scalar on the device
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)

    def layer(vals, li, cache):
        # the cache (or Mamba state) is written in place: the scanned
        # layers' caches are views into the stacked tensors
        nonlocal x, aux_total
        x, _, a = block_apply(tree_cast(vals, cdtype), cfg, specs[li], x,
                              positions, cache=cache, fresh=fresh)
        if a is not None:
            aux_total = aux_total + a

    for j in range(pre):
        layer(values["pre"][f"q{j}"], j,
              None if caches is None else caches["pre"][f"q{j}"])
    for r in range(reps):
        for pos in range(p):
            vals = tree_map(lambda v: v[r], values["scan"][f"p{pos}"])
            cache = None if caches is None else tree_map(
                lambda c: c[r], caches["scan"][f"p{pos}"])
            layer(vals, pre + r * p + pos, cache)
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
    return logits.to(logits_dtype), caches, aux_total


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, device=None):
    check_decoder(cfg)
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
