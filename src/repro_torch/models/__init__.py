"""The port's model zoo: the JAX package's architecture configs
(``config``, pure dataclasses), the torch layers, the LM drivers
(decoder-only and whisper's encoder-decoder) and the training loss.

Exports the names of ``repro.models``.
"""

from .config import BlockSpec, ModelConfig, reduced
from .layers import Param, is_param, param_axes, param_values, tree_cast
from .lm import (cache_axes, encdec_apply, init_caches, lm_apply, lm_init,
                 lm_loss)

__all__ = ["BlockSpec", "ModelConfig", "reduced", "Param", "is_param",
           "param_axes", "param_values", "tree_cast", "cache_axes",
           "encdec_apply", "init_caches", "lm_apply", "lm_init", "lm_loss"]
