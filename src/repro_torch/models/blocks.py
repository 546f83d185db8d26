"""Transformer/SSM blocks: pre-norm mixer + pre-norm FFN/MoE, by BlockSpec.

The port covers the attention mixers (``ATTN``, ``ATTN_LOCAL``) and Mamba,
with the dense FFN, the MoE, Arctic's dense-parallel-MoE or none; MLA,
mLSTM and sLSTM raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from .config import (
    ATTN,
    ATTN_LOCAL,
    ATTN_MLA,
    FFN_DENSE,
    FFN_MOE,
    FFN_MOE_RESIDUAL,
    FFN_NONE,
    MAMBA,
    MLSTM,
    SLSTM,
    BlockSpec,
    ModelConfig,
)
from .layers import (
    attention_apply,
    attention_init,
    ffn_apply,
    ffn_init,
    mamba_apply,
    mamba_init,
    moe_apply,
    moe_init,
    not_ported,
    rmsnorm,
    rmsnorm_init,
)

_MIXER_NAMES = {ATTN_MLA: "MLA attention", MLSTM: "mLSTM", SLSTM: "sLSTM"}
_FFNS = (FFN_DENSE, FFN_MOE, FFN_MOE_RESIDUAL, FFN_NONE)


def check_supported(spec: BlockSpec) -> None:
    """Raise ``NotImplementedError`` for a block kind the port lacks."""
    if spec.mixer not in (ATTN, ATTN_LOCAL, MAMBA):
        if spec.mixer in _MIXER_NAMES:
            raise not_ported(_MIXER_NAMES[spec.mixer], "A3")
        raise ValueError(spec.mixer)
    if spec.ffn not in _FFNS:
        raise ValueError(spec.ffn)


def block_init(gen, cfg: ModelConfig, spec: BlockSpec, dtype=torch.float32,
               device=None):
    check_supported(spec)
    p: Dict[str, Any] = {"norm1": rmsnorm_init(cfg.d_model, dtype, device)}
    if spec.mixer == MAMBA:
        p["mixer"] = mamba_init(gen, cfg, dtype, device)
    else:
        p["mixer"] = attention_init(gen, cfg, dtype, device)
    if spec.ffn != FFN_NONE:
        p["norm2"] = rmsnorm_init(cfg.d_model, dtype, device)
    if spec.ffn in (FFN_MOE, FFN_MOE_RESIDUAL):
        p["moe"] = moe_init(gen, cfg, dtype, device)
    if spec.ffn in (FFN_DENSE, FFN_MOE_RESIDUAL):
        p["ffn"] = ffn_init(gen, cfg.d_model, cfg.d_ff, dtype, device)
    return p


def block_apply(
    params,
    cfg: ModelConfig,
    spec: BlockSpec,
    x,
    positions,
    cache: Optional[Dict] = None,
    kv_source: Optional[torch.Tensor] = None,
    fresh: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict], Optional[torch.Tensor]]:
    """Returns (x, cache, aux_loss): the cache or Mamba state written in
    place; the MoE's aux loss, ``None`` for a block without one.
    ``fresh`` as in :func:`repro_torch.models.layers.attention_apply`."""
    check_supported(spec)
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    if spec.mixer == MAMBA:
        out, new_cache = mamba_apply(params["mixer"], cfg, h, state=cache)
    else:
        window = cfg.sliding_window if spec.mixer == ATTN_LOCAL else 0
        out, new_cache = attention_apply(params["mixer"], cfg, h, positions,
                                         window=window, cache=cache,
                                         kv_source=kv_source, fresh=fresh)
    x = x + out
    aux = None
    if spec.ffn != FFN_NONE:
        h = rmsnorm(params["norm2"], x, cfg.norm_eps)
        if spec.ffn == FFN_DENSE:
            x = x + ffn_apply(params["ffn"], h, cfg.act)
        else:
            mo, aux = moe_apply(params["moe"], cfg, h, cfg.act)
            if spec.ffn == FFN_MOE_RESIDUAL:  # Arctic: dense residual || MoE
                mo = mo + ffn_apply(params["ffn"], h, cfg.act)
            x = x + mo
    return x, new_cache, aux


def init_cache_for_block(cfg: ModelConfig, spec: BlockSpec, batch: int,
                         max_len: int, dtype=torch.bfloat16,
                         device=None) -> Optional[Dict]:
    """Decode-time cache/state skeleton for one layer."""
    check_supported(spec)
    if spec.mixer == MAMBA:
        di = cfg.mamba_expand * cfg.d_model
        return {
            "conv": torch.zeros((batch, cfg.mamba_d_conv - 1, di),
                                dtype=dtype, device=device),
            "ssm": torch.zeros((batch, di, cfg.mamba_d_state),
                               dtype=torch.float32, device=device),
        }
    window = cfg.sliding_window if spec.mixer == ATTN_LOCAL else 0
    T = min(max_len, window) if window else max_len  # ring for local layers
    return {
        "k": torch.zeros((batch, T, cfg.n_kv_heads, cfg.head_dim),
                         dtype=dtype, device=device),
        "v": torch.zeros((batch, T, cfg.n_kv_heads, cfg.v_dim), dtype=dtype,
                         device=device),
        "pos": torch.full((T,), -1, dtype=torch.int32, device=device),
        "len": torch.zeros((), dtype=torch.int32, device=device),
    }


def cache_axes_for_block(cfg: ModelConfig, spec: BlockSpec) -> Optional[Dict]:
    """Logical axes parallel to init_cache_for_block's value tree."""
    check_supported(spec)
    if spec.mixer == MAMBA:
        return {"conv": ("batch", None, "mamba_inner"),
                "ssm": ("batch", "mamba_inner", None)}
    return {
        "k": ("batch", "seq_kv", "kv_heads", None),
        "v": ("batch", "seq_kv", "kv_heads", None),
        "pos": ("seq_kv",),
        "len": (),
    }
