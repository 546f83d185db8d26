"""Training of the port's LMs: AdamW and the train/eval steps (the JAX
package's ``repro.train``)."""

from .optimizer import (
    AdamWConfig,
    AdamWState,
    adamw_init,
    adamw_update,
    global_norm,
    schedule_lr,
)
from .trainstep import loss_and_grads, make_eval_step, make_train_step

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "global_norm", "loss_and_grads", "make_eval_step",
           "make_train_step", "schedule_lr"]
