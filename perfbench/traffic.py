"""The one generator of traffic: it reads a mix's parameters
(``traffic/<name>.json``) and makes the batches of a closed loop from the
seed.

A mix gives ``batch`` requests a batch, the prompt lengths
``prompt_lens``, ``new_tokens`` a request and the cache's dtype.  The
batches come in blocks of ``len(prompt_lens)``; each block holds every
length once, in an order drawn from the seed, so that every seed serves
the same sizes and only their order and the tokens differ.  Prompt tokens
are drawn uniformly over the whole vocabulary.  Batch ``i`` of a seed is
the same whatever was drawn before it, so a batch can be made again.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

#: stream tags that keep the draws of the window, the warm-up and the
#: sample of the check apart
WINDOW, WARMUP, SAMPLE = 0, 1, 2


@dataclass
class Batch:
    index: int
    prompt_len: int
    prompts: np.ndarray          # [batch, prompt_len] int32
    new_tokens: int


def prompt_len(mix: dict, seed: int, index: int) -> int:
    """The prompt length of batch ``index`` of ``seed``."""
    lens = list(mix["prompt_lens"])
    block, pos = divmod(index, len(lens))
    order = np.random.default_rng([seed, WINDOW, block]).permutation(len(lens))
    return int(lens[order[pos]])


def batch(mix: dict, vocab: int, seed: int, index: int,
          stream: int = WINDOW) -> Batch:
    """Batch ``index`` of ``seed``'s stream: the window's batches follow
    :func:`prompt_len`; the warm-up's batch ``i`` takes the ``i``-th
    length of the mix."""
    if stream == WINDOW:
        p = prompt_len(mix, seed, index)
    else:
        p = int(mix["prompt_lens"][index % len(mix["prompt_lens"])])
    rng = np.random.default_rng([seed, stream, index])
    prompts = rng.integers(0, vocab, size=(mix["batch"], p), dtype=np.int64)
    return Batch(index, p, prompts.astype(np.int32), int(mix["new_tokens"]))


def warmup_batches(mix: dict, vocab: int, seed: int) -> List[Batch]:
    """One batch at each prompt length of the mix: every shape the window
    will use."""
    return [batch(mix, vocab, seed, i, WARMUP)
            for i in range(len(mix["prompt_lens"]))]


def max_len(mix: dict) -> int:
    """The cache length that holds the mix's longest request: its prompt,
    its new tokens and 8 slots more, as the serving driver sizes it."""
    return max(mix["prompt_lens"]) + int(mix["new_tokens"]) + 8


def sample(mix: dict, seed: int, finished: List[tuple]) -> List[tuple]:
    """``check_requests`` of the ``finished`` requests ((batch index, row,
    prompt length) each), drawn from the seed, with one of the longest
    prompts among them."""
    n = min(int(mix["check_requests"]), len(finished))
    if not n:
        return []
    rng = np.random.default_rng([seed, SAMPLE])
    longest = max(r[2] for r in finished)
    long_ids = [i for i, r in enumerate(finished) if r[2] == longest]
    first = long_ids[int(rng.integers(len(long_ids)))]
    rest = [i for i in range(len(finished)) if i != first]
    picked = [first] + list(rng.choice(rest, size=n - 1, replace=False)) \
        if n > 1 else [first]
    return [finished[i] for i in sorted(int(i) for i in picked)]
