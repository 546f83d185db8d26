"""The plain reference of the benchmark's models: fp32 PyTorch, no kernel,
no cache, no batching, one module a mechanism, found by the name the
configuration's ``layers`` give it (:func:`perfbench.spec.mechanism`).
It imports nothing of the program, and reads the sizes from the
configuration file's published keys and its ``layers`` list.

:func:`forward` is the model's full forward over a block of sequences
(each a prompt and the tokens served after it), with the MoE's capacity
per forward as a server runs them (:mod:`.moe`); it returns the logits at
the positions asked for.  ``quant="fp8"`` computes the blocks' products
with both operands rounded to float8 e4m3: the control, one precision
below the configuration's bf16; ``quant="bf16"`` rounds them to bf16.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from .. import spec
from .linear import precise
from .norm import rmsnorm


class Forward(NamedTuple):
    """What a mechanism's ``residual(p, c, x, fwd)`` may read besides its
    weights, the configuration and its input ``x [B, S, d]``."""

    pos: torch.Tensor            # [S]: the positions of x's tokens
    prompt_len: int              # the first prompt_len tokens: one forward
    quant: Optional[str] = None  # the products' rounding (:mod:`.linear`)
    margins: Optional[list] = None  # router margins, where asked for


def forward(c: dict, w: dict, tokens: torch.Tensor, prompt_len: int,
            rows: Sequence[int], quant: Optional[str] = None,
            margins: Optional[list] = None) -> torch.Tensor:
    """Logits ``[B, len(rows), vocab]`` (fp32) of the sequences ``tokens
    [B, T]`` whose first ``prompt_len`` tokens are the prompt, at the
    positions ``rows``.  ``margins``, where given, gets each MoE layer's
    router margins (:func:`.moe.route`)."""
    precise()
    eps = c["rms_norm_eps"]
    fwd = Forward(torch.arange(tokens.shape[1], device=tokens.device),
                  prompt_len, quant, margins)
    x = w["embed"][tokens].float()
    for names, lw in zip(c["layers"], w["layers"]):
        for norm, name in zip(("norm1", "norm2"), names):
            m = spec.mechanism(name)
            x = x + m.residual(lw[m.KEY], c,
                               rmsnorm(x, lw[norm]["scale"], eps), fwd)
    out = rmsnorm(x[:, list(rows)], w["final_norm"]["scale"], eps)
    return out @ w["head"].float()
