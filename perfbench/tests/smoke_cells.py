"""Cells at the port's smoke widths for the CPU tests: the configuration
files' keys worked out from ``get_config(arch, smoke=True)``."""

from __future__ import annotations

import dataclasses
import math

from repro_torch.configs import get_config
from repro_torch.models.config import ModelConfig

from perfbench import weights

SMOKE_MIX = {"loop": "closed", "batch": 2, "prompt_lens": [12, 20],
             "new_tokens": 4, "cache_dtype": "float32", "check_requests": 4,
             "trace_batches": 1}


def config(arch: str, **port) -> dict:
    """The configuration file of ``arch``'s smoke config (with ``port``
    fields changed): the published keys, ``layers`` and ``port``."""
    cfg: ModelConfig = get_config(arch, smoke=True).with_(**port)
    c = {"hidden_size": cfg.d_model, "num_attention_heads": cfg.n_heads,
         "num_key_value_heads": cfg.n_kv_heads,
         "intermediate_size": cfg.d_ff, "vocab_size": cfg.vocab,
         "rms_norm_eps": cfg.norm_eps, "rope_theta": cfg.rope_theta,
         "num_experts_per_tok": cfg.top_k,
         "moe_intermediate_size": cfg.d_ff_expert,
         "assumed": {"capacity_factor": cfg.capacity_factor}}
    if cfg.kv_lora_rank:
        c.update(qk_nope_head_dim=cfg.head_dim,
                 qk_rope_head_dim=cfg.rope_head_dim,
                 v_head_dim=cfg.v_dim, q_lora_rank=cfg.q_lora_rank,
                 kv_lora_rank=cfg.kv_lora_rank,
                 n_routed_experts=cfg.n_experts,
                 n_shared_experts=cfg.n_shared_experts)
    else:
        c.update(num_experts=cfg.n_experts, mamba_d_state=cfg.mamba_d_state,
                 mamba_d_conv=cfg.mamba_d_conv,
                 mamba_expand=cfg.mamba_expand,
                 mamba_dt_rank=math.ceil(cfg.d_model / 16))
    c["layers"] = weights.layer_kinds(cfg)
    c["port"] = dataclasses.asdict(cfg)
    return c


def cell(arch: str, limit: float = 1e-4, mix: dict = None, **port) -> dict:
    """A cell as :func:`perfbench.spec.cell` gives one, at smoke widths."""
    return {"name": f"{arch}.smoke", "chips": 1,
            "config": config(arch, **port),
            "mix": dict(SMOKE_MIX, **(mix or {})),
            "limits": {"mean_gap": limit},
            "metrics": {0: [("setup_s", "s"), ("output_tokens_per_s",
                                               "tokens/s"),
                            ("ttft_p95_ms", "ms"), ("serve_mfu", "%"),
                            ("prefill_ms", "ms"), ("decode_step_ms", "ms")],
                        1: []}}
