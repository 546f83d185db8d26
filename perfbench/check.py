"""The comparison that decides ``correct``: the reference's logits over each
sampled prompt with the tokens the program served after it, and the gap
by which each served token's logit lies below the reference's best there.

Greedy serving picks the largest logit, so a sound program's token lies
within its rounding of the reference's best; a wrong one lies further
below it.  The number compared is the mean gap over the sampled tokens
(``mean_gap``; PERF.md gives the readings it was set from and why not the
widest gap).  ``lows`` also runs the reference in lower precisions on the
same tokens and reads the gaps of the tokens each ranks first: "fp8", the
control that has to fail the limit, and "bf16", bf16 products beside the
program's bf16.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from perfbench import reference

#: sequences the reference runs at once
BLOCK = 4


def _gaps(logits: torch.Tensor, best: torch.Tensor,
          picked: torch.Tensor) -> torch.Tensor:
    return best - logits.gather(-1, picked[..., None])[..., 0]


def gaps(c: dict, w: dict, requests: Sequence[tuple], device,
         lows: Sequence[str] = (), look: bool = False) -> List[Dict]:
    """For each request (prompt int array, served token list): ``gaps``,
    the served tokens' gaps below the reference's best (fp32, in order),
    and for each precision ``q`` in ``lows`` ``q``, the gaps of that
    forward's first choices.  With ``look``, ``margin``: at each served
    token's position, the least router margin over the MoE layers
    (:func:`perfbench.reference.moe.route`).  Requests of one prompt
    length and served length run ``BLOCK`` at a time."""
    out: List[Dict] = [None] * len(requests)
    groups: Dict[tuple, List[int]] = {}
    for i, (prompt, served) in enumerate(requests):
        groups.setdefault((len(prompt), len(served)), []).append(i)
    with torch.no_grad():
        for (P, n), ids in groups.items():
            rows = list(range(P - 1, P + n - 1))
            for b0 in range(0, len(ids), BLOCK):
                blk = ids[b0:b0 + BLOCK]
                seqs = [np.concatenate([np.asarray(requests[i][0]),
                                        np.asarray(requests[i][1][:-1],
                                                   dtype=np.int64)])
                        for i in blk]
                tokens = torch.as_tensor(np.stack(seqs).astype(np.int64),
                                         device=device)
                served = torch.as_tensor(
                    np.asarray([requests[i][1] for i in blk],
                               dtype=np.int64), device=device)
                margins = [] if look else None
                ref = reference.forward(c, w, tokens, P, rows,
                                        margins=margins)
                best = ref.max(-1).values
                g = {"gaps": _gaps(ref, best, served).cpu().numpy()}
                if margins:
                    g["margin"] = torch.stack(margins).amin(0)[
                        :, rows].cpu().numpy()
                for q in lows:
                    low = reference.forward(c, w, tokens, P, rows, quant=q)
                    g[q] = _gaps(ref, best, low.argmax(-1)).cpu().numpy()
                    del low
                for j, i in enumerate(blk):
                    out[i] = {k: v[j].tolist() for k, v in g.items()}
                del ref
    return out


def mean_gap(read: List[Dict], key: str = "gaps") -> float:
    """The mean of the gaps ``key`` over every sampled token."""
    g = [x for r in read for x in r[key]]
    return sum(g) / len(g) if g else None
