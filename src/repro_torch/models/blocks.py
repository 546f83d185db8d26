"""Transformer blocks: pre-norm mixer + pre-norm FFN, by BlockSpec.

The port covers the attention mixers (``ATTN``, ``ATTN_LOCAL``) with the
dense FFN or none; MLA, MoE, Mamba, mLSTM and sLSTM raise
``NotImplementedError`` naming their ROADMAP item.
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
    not_ported,
    rmsnorm,
    rmsnorm_init,
)

_MIXER_NAMES = {ATTN_MLA: "MLA attention", MAMBA: "Mamba", MLSTM: "mLSTM",
                SLSTM: "sLSTM"}
_FFN_NAMES = {FFN_MOE: "MoE", FFN_MOE_RESIDUAL: "MoE"}


def check_supported(spec: BlockSpec) -> None:
    """Raise ``NotImplementedError`` for a block kind the port lacks."""
    if spec.mixer not in (ATTN, ATTN_LOCAL):
        if spec.mixer in _MIXER_NAMES:
            raise not_ported(_MIXER_NAMES[spec.mixer], "A3")
        raise ValueError(spec.mixer)
    if spec.ffn not in (FFN_DENSE, FFN_NONE):
        if spec.ffn in _FFN_NAMES:
            raise not_ported(_FFN_NAMES[spec.ffn], "A3")
        raise ValueError(spec.ffn)


def block_init(gen, cfg: ModelConfig, spec: BlockSpec, dtype=torch.float32,
               device=None):
    check_supported(spec)
    p: Dict[str, Any] = {"norm1": rmsnorm_init(cfg.d_model, dtype, device),
                         "mixer": attention_init(gen, cfg, dtype, device)}
    if spec.ffn == FFN_DENSE:
        p["norm2"] = rmsnorm_init(cfg.d_model, dtype, device)
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
) -> Tuple[torch.Tensor, Optional[Dict], float]:
    """Returns (x, cache, aux_loss); ``fresh`` as in
    :func:`repro_torch.models.layers.attention_apply`."""
    check_supported(spec)
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    window = cfg.sliding_window if spec.mixer == ATTN_LOCAL else 0
    out, new_cache = attention_apply(params["mixer"], cfg, h, positions,
                                     window=window, cache=cache,
                                     kv_source=kv_source, fresh=fresh)
    x = x + out
    if spec.ffn == FFN_DENSE:
        h = rmsnorm(params["norm2"], x, cfg.norm_eps)
        x = x + ffn_apply(params["ffn"], h, cfg.act)
    return x, new_cache, 0.0


def init_cache_for_block(cfg: ModelConfig, spec: BlockSpec, batch: int,
                         max_len: int, dtype=torch.bfloat16,
                         device=None) -> Optional[Dict]:
    """Decode-time cache skeleton for one layer."""
    check_supported(spec)
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
    return {
        "k": ("batch", "seq_kv", "kv_heads", None),
        "v": ("batch", "seq_kv", "kv_heads", None),
        "pos": ("seq_kv",),
        "len": (),
    }
