"""The port's model zoo: the JAX package's architecture configs
(``config``, pure dataclasses) and the torch layers / LM driver of the
attention + dense-FFN subset.

Exports the names of ``repro.models`` that are ported; ``encdec_apply`` and
``lm_loss`` wait for later slices (ROADMAP A4, A5).
"""

from .config import BlockSpec, ModelConfig, reduced
from .layers import Param, is_param, param_axes, param_values, tree_cast
from .lm import cache_axes, init_caches, lm_apply, lm_init

__all__ = ["BlockSpec", "ModelConfig", "reduced", "Param", "is_param",
           "param_axes", "param_values", "tree_cast", "cache_axes",
           "init_caches", "lm_apply", "lm_init"]
