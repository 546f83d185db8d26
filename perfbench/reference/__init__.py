"""The plain reference of the benchmark's models: fp32 PyTorch, no kernel,
no cache, no batching, one module a mechanism.  It imports nothing of the
program, and reads the sizes from the configuration file's published
keys and its ``layers`` list.

:func:`forward` is the model's full forward over a block of sequences
(each a prompt and the tokens served after it), with the MoE's capacity
per forward as a server runs them (:mod:`.moe`); it returns the logits at
the positions asked for.  ``quant="fp8"`` computes the blocks' products
with both operands rounded to float8 e4m3: the control, one precision
below the configuration's bf16; ``quant="bf16"`` rounds them to bf16.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from . import dense, gqa, mamba, mla, moe
from .linear import precise
from .norm import rmsnorm

MIXERS = {"mla": mla, "gqa": gqa, "mamba": mamba}


def forward(c: dict, w: dict, tokens: torch.Tensor, prompt_len: int,
            rows: Sequence[int], quant: Optional[str] = None,
            margins: Optional[list] = None) -> torch.Tensor:
    """Logits ``[B, len(rows), vocab]`` (fp32) of the sequences ``tokens
    [B, T]`` whose first ``prompt_len`` tokens are the prompt, at the
    positions ``rows``.  ``margins``, where given, gets each MoE layer's
    router margins (:func:`.moe.route`)."""
    precise()
    eps = c["rms_norm_eps"]
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    x = w["embed"][tokens].float()
    for (mixer, ffn), lw in zip(c["layers"], w["layers"]):
        hn = rmsnorm(x, lw["norm1"]["scale"], eps)
        if mixer == "mamba":
            x = x + mamba.apply(lw["mixer"], c, hn, quant)
        else:
            x = x + MIXERS[mixer].apply(lw["mixer"], c, hn, pos, quant)
        hn = rmsnorm(x, lw["norm2"]["scale"], eps)
        if ffn == "moe":
            x = x + moe.apply(lw["moe"], c, hn, prompt_len, quant, margins)
        else:
            x = x + dense.apply(lw["ffn"], hn, quant)
    out = rmsnorm(x[:, list(rows)], w["final_norm"]["scale"], eps)
    return out @ w["head"].float()
