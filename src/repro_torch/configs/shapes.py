"""Assigned input-shape grid (seq_len x global_batch) and per-arch cell rules.

``decode_*`` / ``long_*`` lower ``serve_step`` (one token against a KV
cache/state of seq_len); ``train_4k`` lowers ``train_step``; ``prefill_32k``
lowers ``prefill_step``.  ``long_500k`` runs only for sub-quadratic archs
(see DESIGN.md §4): xlstm (SSM state), jamba (hybrid), gemma3 (5:1 sliding
window); it is N/A for the pure full-attention archs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

# archs allowed to run long_500k (sub-quadratic sequence mixing)
LONG_CONTEXT_OK = {"xlstm-350m", "jamba-v0.1-52b", "gemma3-4b"}


def cells_for(arch: str) -> List[str]:
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if arch in LONG_CONTEXT_OK:
        out.append("long_500k")
    return out


def skip_reason(arch: str, shape: str) -> str:
    if shape == "long_500k" and arch not in LONG_CONTEXT_OK:
        return ("N/A: pure full-attention arch — 500k prefill is quadratic "
                "(DESIGN.md §4)")
    return ""
