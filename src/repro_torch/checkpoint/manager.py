"""Checkpoint manager: retention, resume and async save (the JAX package's
``repro.checkpoint.manager``).  Resharding onto another mesh waits for the
port's meshes (ROADMAP A8)."""

from __future__ import annotations

import os
import shutil
import threading
from dataclasses import dataclass
from typing import Dict, Optional

from .io import (checkpoint_steps, fill_template, keypath_items,
                 load_checkpoint, save_checkpoint, to_numpy)


@dataclass
class CheckpointConfig:
    directory: str
    save_every: int = 100
    keep_last: int = 3
    keep_every: int = 0            # additionally keep every k-th (0 = off)
    async_save: bool = True


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

        if blocking or not self.cfg.async_save:
            work()
        else:
            self._pending = threading.Thread(target=work, daemon=True)
            self._pending.start()

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

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


def reshard_to(tree, shardings):
    """Placing a restored tree onto a new mesh waits for the port's
    meshes."""
    raise NotImplementedError("reshard_to is not ported to repro_torch yet "
                              "(ROADMAP A8)")
