"""Batched serving engine: prefill + greedy decode over the port's model
zoo (the JAX package's ``repro.serve.engine.ServeEngine``).

Requests are grouped by prompt length (static batching with length
bucketing); each group is prefilled in one batched forward that also fills
the caches (attention rings, MLA's latent cache, and the Mamba, mLSTM and
sLSTM states of the recurrent archs), then decoded synchronously with the reference's stop rule.
What differs from the reference, none of it in the tokens:

* the parameters are cast to the compute dtype once, at construction (the
  reference's ``lm_apply`` casts them on every call; the values are the
  same, the per-step copy is gone), the fp32 MoE router and Mamba
  ``A_log`` included, as the reference casts them.  ``final_norm`` keeps
  its dtype, as the reference reads it in fp32;
* the prefill computes the final norm and the head on the last position
  only, the one row the reference reads (``last_only``), and tells the
  model the caches are empty (``prefill``), which lets attention take the
  flash-attention kernel;
* the chosen tokens cross to the host once per step (``tolist``).

The cache dtype defaults to float32, as the reference's does.  For a bf16
model that promotes the attention output, and from the first layer on the
residual stream, to fp32 (the port mirrors jnp's promotion), so the
default serves what the reference serves; ``cache_dtype=torch.bfloat16``
keeps the whole forward in bf16.

``stats`` records, per group, the time to the first tokens on the host
(``ttft_s``, cache allocation included), the prefill forward's share of it
(``prefill_s``) and the decode steps' wall time (host clock; each step ends
with its tokens on the host, so no device work is left outside it).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.models import init_caches, lm_apply
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import not_ported, tree_cast
from repro_torch.models.lm import torch_dtype


@dataclass
class Request:
    rid: int
    prompt: np.ndarray               # [S] int32
    max_new_tokens: int = 16
    generated: List[int] = field(default_factory=list)


@dataclass
class ServeConfig:
    max_batch: int = 8
    max_len: int = 512
    cache_dtype: torch.dtype = torch.float32  # the reference's default
    greedy: bool = True


class ServeEngine:
    """Length-bucketed batch serving for decoder-only archs, on the device
    that holds ``values``."""

    def __init__(self, cfg: ModelConfig, values, scfg: ServeConfig):
        if cfg.is_encdec:
            raise not_ported(f"EncDecEngine ({cfg.name})", "A6")
        self.cfg = cfg
        self.scfg = scfg
        cdtype = torch_dtype(cfg.compute_dtype)
        self.values = {k: (v if k == "final_norm" else tree_cast(v, cdtype))
                       for k, v in values.items()}
        self.device = values["embed"].device
        self.cache_dtype = scfg.cache_dtype
        self.stats: List[Dict[str, Any]] = []

    def _generate_group(self, group: List[Request]) -> None:
        B = len(group)
        P = len(group[0].prompt)
        t0 = time.perf_counter()
        caches = init_caches(self.cfg, B, self.scfg.max_len,
                             self.cache_dtype, self.device)
        tokens = torch.from_numpy(
            np.stack([r.prompt for r in group]).astype(np.int64)).to(
                self.device)
        t_prefill = time.perf_counter()
        logits, caches, _ = lm_apply(self.values, self.cfg, tokens,
                                     caches=caches, prefill=True,
                                     last_only=True)
        cur = torch.argmax(logits[:, -1, :], dim=-1)
        host = cur.tolist()
        t_first = time.perf_counter()
        steps = max(r.max_new_tokens for r in group)
        decoded = 0
        t1 = time.perf_counter()
        for t in range(steps):
            for i, r in enumerate(group):
                if len(r.generated) < r.max_new_tokens:
                    r.generated.append(host[i])
            if t == steps - 1 or P + t + 1 >= self.scfg.max_len:
                break
            pos = torch.full((B, 1), P + t, dtype=torch.int64,
                             device=self.device)
            logits, caches, _ = lm_apply(self.values, self.cfg, cur[:, None],
                                         positions=pos, caches=caches)
            cur = torch.argmax(logits[:, -1, :], dim=-1)
            host = cur.tolist()
            decoded += 1
        self.stats.append({"batch": B, "prompt_len": P,
                           "ttft_s": t_first - t0,
                           "prefill_s": t_first - t_prefill,
                           "decode_steps": decoded,
                           "decode_s": time.perf_counter() - t1})

    def generate(self, requests: List[Request]) -> Dict[int, List[int]]:
        """Length-bucketed batched generation."""
        by_len: Dict[int, List[Request]] = {}
        for r in requests:
            by_len.setdefault(len(r.prompt), []).append(r)
        for _, reqs in sorted(by_len.items()):
            for i in range(0, len(reqs), self.scfg.max_batch):
                self._generate_group(reqs[i: i + self.scfg.max_batch])
        return {r.rid: r.generated for r in requests}
