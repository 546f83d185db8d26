"""Deterministic synthetic token pipeline (the JAX package's
``repro.data.synthetic``).

Batch ``i`` is a pure function of (seed, step): :meth:`SyntheticLM.batch_at`
is the reference's NumPy, line for line, so both packages draw the same
bits and a restart replays the stream exactly.  :class:`PrefetchingLoader`
also moves each batch to the device in its worker thread (pinned host
memory, a non-blocking copy).
"""

from __future__ import annotations

import queue as queue_mod
import threading
from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np
import torch


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # markov-chain-ish structure so the LM has something learnable
    n_patterns: int = 97


class SyntheticLM:
    """Learnable synthetic text: tokens follow a seeded affine recurrence
    ``t_{i+1} = (a * t_i + b) % vocab`` with per-sequence (a, b) drawn from a
    small pattern set."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        self.pat_a = rng.integers(1, cfg.vocab - 1, cfg.n_patterns)
        self.pat_b = rng.integers(0, cfg.vocab - 1, cfg.n_patterns)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        B, S = cfg.global_batch, cfg.seq_len
        pat = rng.integers(0, cfg.n_patterns, B)
        a = self.pat_a[pat][:, None].astype(np.int64)
        b = self.pat_b[pat][:, None].astype(np.int64)
        t0 = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int64)
        toks = np.empty((B, S), np.int64)
        toks[:, :1] = t0
        for i in range(1, S):
            toks[:, i: i + 1] = (a * toks[:, i - 1: i] + b) % cfg.vocab
        return {
            "tokens": toks.astype(np.int32),
            "loss_mask": np.ones((B, S), np.float32),
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A NumPy batch as tensors on ``device`` (on a CUDA device through
    pinned host memory and a non-blocking copy)."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = (t.pin_memory().to(device, non_blocking=True)
                  if device.type == "cuda" else t.to(device))
    return out


class PrefetchingLoader:
    """Background-thread prefetch: the worker builds each batch and moves
    it to ``device`` (``None``: NumPy arrays, as the reference yields)."""

    def __init__(self, source: SyntheticLM, start_step: int = 0,
                 depth: int = 2, device=None):
        self.source = source
        self.device = device
        self.step = start_step
        self.q: queue_mod.Queue = queue_mod.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        s = self.step
        while not self._stop.is_set():
            item = self.source.batch_at(s)
            if self.device is not None:
                item = to_device(item, self.device)
            while not self._stop.is_set():
                try:
                    self.q.put(item, timeout=0.5)
                    break
                except queue_mod.Full:
                    continue
            s += 1

    def __next__(self):
        item = self.q.get()
        self.step += 1
        return item

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2.0)
