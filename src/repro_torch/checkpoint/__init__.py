from .io import (checkpoint_steps, keypath_items, load_checkpoint,
                 save_checkpoint, tree_to_torch)
from .manager import CheckpointConfig, CheckpointManager, reshard_to

__all__ = ["CheckpointConfig", "CheckpointManager", "checkpoint_steps",
           "keypath_items", "load_checkpoint", "reshard_to",
           "save_checkpoint", "tree_to_torch"]
