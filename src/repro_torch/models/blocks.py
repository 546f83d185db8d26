"""Transformer/SSM blocks: pre-norm mixer + pre-norm FFN/MoE, by BlockSpec.

Every mixer of the JAX package (attention, local attention, MLA, Mamba,
mLSTM, sLSTM) with the dense FFN, the MoE, Arctic's dense-parallel-MoE or
none.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.parallel.sharding import shard

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
    mla_apply,
    mla_init,
    mlstm_apply,
    mlstm_init,
    moe_apply,
    moe_init,
    rmsnorm,
    rmsnorm_init,
    slstm_apply,
    slstm_init,
    slstm_initial_state,
)

_MIXER_INITS = {ATTN: attention_init, ATTN_LOCAL: attention_init,
                ATTN_MLA: mla_init, MAMBA: mamba_init, MLSTM: mlstm_init,
                SLSTM: slstm_init}
_FFNS = (FFN_DENSE, FFN_MOE, FFN_MOE_RESIDUAL, FFN_NONE)


def check_supported(spec: BlockSpec) -> None:
    """Raise ``ValueError`` for a block kind the JAX package lacks too."""
    if spec.mixer not in _MIXER_INITS:
        raise ValueError(spec.mixer)
    if spec.ffn not in _FFNS:
        raise ValueError(spec.ffn)


def block_init(gen, cfg: ModelConfig, spec: BlockSpec, dtype=torch.float32,
               device=None):
    check_supported(spec)
    p: Dict[str, Any] = {"norm1": rmsnorm_init(cfg.d_model, dtype, device)}
    p["mixer"] = _MIXER_INITS[spec.mixer](gen, cfg, dtype, device)
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
    bidirectional: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict], Optional[torch.Tensor]]:
    """Returns (x, cache, aux_loss): the cache or recurrent state written
    in place; the MoE's aux loss, ``None`` for a block without one.
    ``fresh`` and ``bidirectional`` as in
    :func:`repro_torch.models.layers.attention_apply`."""
    check_supported(spec)
    # Megatron-SP: the residual stream lives seq-sharded between blocks (a
    # no-op unless the "seq_res" rule maps to a mesh axis); the norm runs on
    # the shard, the mixer/FFN gather the sequence and their TP outputs
    # reduce back
    x = shard(x, "batch", "seq_res", None)
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    h = shard(h, "batch", None, None)
    if spec.mixer == MAMBA:
        out, new_cache = mamba_apply(params["mixer"], cfg, h, state=cache)
    elif spec.mixer == MLSTM:
        out, new_cache = mlstm_apply(params["mixer"], cfg, h, state=cache)
    elif spec.mixer == SLSTM:
        out, new_cache = slstm_apply(params["mixer"], cfg, h, state=cache)
    elif spec.mixer == ATTN_MLA:
        out, new_cache = mla_apply(params["mixer"], cfg, h, positions,
                                   cache=cache, fresh=fresh)
    else:
        window = cfg.sliding_window if spec.mixer == ATTN_LOCAL else 0
        out, new_cache = attention_apply(params["mixer"], cfg, h, positions,
                                         window=window, cache=cache,
                                         kv_source=kv_source, fresh=fresh,
                                         bidirectional=bidirectional)
    x = x + shard(out, "batch", "seq_res", None)
    aux = None
    if spec.ffn != FFN_NONE:
        h = rmsnorm(params["norm2"], x, cfg.norm_eps)
        h = shard(h, "batch", None, None)
        if spec.ffn == FFN_DENSE:
            x = x + shard(ffn_apply(params["ffn"], h, cfg.act),
                          "batch", "seq_res", None)
        else:
            mo, aux = moe_apply(params["moe"], cfg, h, cfg.act)
            if spec.ffn == FFN_MOE_RESIDUAL:  # Arctic: dense residual || MoE
                mo = mo + ffn_apply(params["ffn"], h, cfg.act)
            x = x + shard(mo, "batch", "seq_res", None)
    return x, new_cache, aux


def init_cache_for_block(cfg: ModelConfig, spec: BlockSpec, batch: int,
                         max_len: int, dtype=torch.bfloat16,
                         device=None) -> Optional[Dict]:
    """Decode-time cache/state skeleton for one layer; every leaf its own
    tensor (the reference's sLSTM state shares one array between ``c`` and
    ``h``; the port writes states in place, so it cannot)."""
    check_supported(spec)
    if spec.mixer == ATTN_MLA:
        return {
            "ckv": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                               dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, max_len, 1, cfg.rope_head_dim),
                                  dtype=dtype, device=device),
            "len": torch.zeros((), dtype=torch.int32, device=device),
        }
    if spec.mixer == MLSTM:
        di = 2 * cfg.d_model
        dh = di // cfg.n_heads
        return {
            "C": torch.zeros((batch, cfg.n_heads, dh, dh),
                             dtype=torch.float32, device=device),
            "N": torch.zeros((batch, cfg.n_heads, dh), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, 3, di), dtype=dtype, device=device),
        }
    if spec.mixer == SLSTM:
        return slstm_initial_state(batch, cfg.n_heads,
                                   cfg.d_model // cfg.n_heads, device)
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
    if spec.mixer == ATTN_MLA:
        return {
            "ckv": ("batch", "seq_kv", "kv_lora"),
            "k_rope": ("batch", "seq_kv", None, None),
            "len": (),
        }
    if spec.mixer == MLSTM:
        return {"C": ("batch", None, None, None),
                "N": ("batch", None, None),
                "conv": ("batch", None, "lstm_inner")}
    if spec.mixer == SLSTM:
        ax = ("batch", None, None)
        return {"c": ax, "n": ax, "h": ax, "m": ax}
    if spec.mixer == MAMBA:
        return {"conv": ("batch", None, "mamba_inner"),
                "ssm": ("batch", "mamba_inner", None)}
    return {
        "k": ("batch", "seq_kv", "kv_heads", None),
        "v": ("batch", "seq_kv", "kv_heads", None),
        "pos": ("seq_kv",),
        "len": (),
    }
