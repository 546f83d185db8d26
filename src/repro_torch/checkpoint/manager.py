"""Checkpoint manager: retention, resume, async save and elastic
resharding (the JAX package's ``repro.checkpoint.manager``).

Under a process group of several ranks every rank calls ``save``: each
``DTensor`` leaf is gathered whole (a collective), and rank 0 alone writes
the files, so they are the reference's bytes whatever the mesh.  The
other ranks meet rank 0 at its next :meth:`CheckpointManager.wait` (a
barrier), so no rank reads a step before it lands."""

from __future__ import annotations

import os
import shutil
import threading
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch.distributed as dist

from .io import (checkpoint_steps, fill_template, keypath_items,
                 load_checkpoint, save_checkpoint, to_numpy)


@dataclass
class CheckpointConfig:
    directory: str
    save_every: int = 100
    keep_last: int = 3
    keep_every: int = 0            # additionally keep every k-th (0 = off)
    async_save: bool = True


def _rank_world() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class CheckpointManager:
    def __init__(self, cfg: CheckpointConfig):
        self.cfg = cfg
        self._pending: Optional[threading.Thread] = None
        os.makedirs(cfg.directory, exist_ok=True)

    # -- save --------------------------------------------------------------
    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.cfg.save_every == 0

    def save(self, step: int, tree, extra_meta: Optional[Dict] = None,
             blocking: Optional[bool] = None) -> None:
        """The device-to-host copy happens now (snapshot semantics); the
        file write runs on a background thread unless blocking."""
        self.wait()
        host = fill_template(tree, {name: to_numpy(leaf)
                               for name, leaf in keypath_items(tree)})

        def work():
            save_checkpoint(self.cfg.directory, step, host, extra_meta)
            self._retain()

        if _rank_world()[0] != 0:
            return
        if blocking or not self.cfg.async_save:
            work()
        else:
            self._pending = threading.Thread(target=work, daemon=True)
            self._pending.start()

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if _rank_world()[1] > 1:
            dist.barrier()

    def _retain(self):
        steps = checkpoint_steps(self.cfg.directory)
        keep = set(steps[-self.cfg.keep_last:])
        if self.cfg.keep_every:
            keep |= {s for s in steps if s % self.cfg.keep_every == 0}
        for s in steps:
            if s not in keep:
                shutil.rmtree(os.path.join(self.cfg.directory,
                                           f"step_{s:08d}"),
                              ignore_errors=True)

    # -- restore -----------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        """The newest committed step, after any save in flight lands."""
        self.wait()
        steps = checkpoint_steps(self.cfg.directory)
        return steps[-1] if steps else None

    def restore(self, template, step: Optional[int] = None):
        self.wait()
        return load_checkpoint(self.cfg.directory, step, template)


def reshard_to(tree, shardings, device="cpu"):
    """Place host arrays according to new shardings (elastic restart after
    a mesh-shape change: the host holds full arrays, ``distribute_tensor``
    splits them for the new mesh).  ``shardings`` mirrors ``tree``; a leaf
    is ``(mesh, placements)`` (as ``logical_sharding`` gives placements),
    or None for a plain tensor on ``device``."""
    from torch.distributed.tensor import distribute_tensor

    from .io import tree_to_torch

    def place(x, s):
        if isinstance(x, dict):
            return {k: place(x[k], s[k]) for k in x}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(place(a, b) for a, b in zip(x, s)))
        t = tree_to_torch(x, device) if s is None else tree_to_torch(
            x, s[0].device_type)
        return t if s is None else distribute_tensor(t, s[0], s[1])

    return place(tree, shardings)
