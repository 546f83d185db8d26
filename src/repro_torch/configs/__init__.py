"""Architecture registry: the 10 assigned configs (--arch <id>)."""

from . import (
    arctic_480b,
    deepseek_v2_236b,
    gemma3_4b,
    glm4_9b,
    granite_3_8b,
    jamba_v0_1_52b,
    llava_next_34b,
    tinyllama_1_1b,
    whisper_base,
    xlstm_350m,
)
from .shapes import LONG_CONTEXT_OK, SHAPES, ShapeSpec, cells_for, skip_reason

_MODULES = {
    "whisper-base": whisper_base,
    "tinyllama-1.1b": tinyllama_1_1b,
    "glm4-9b": glm4_9b,
    "gemma3-4b": gemma3_4b,
    "granite-3-8b": granite_3_8b,
    "xlstm-350m": xlstm_350m,
    "jamba-v0.1-52b": jamba_v0_1_52b,
    "deepseek-v2-236b": deepseek_v2_236b,
    "arctic-480b": arctic_480b,
    "llava-next-34b": llava_next_34b,
}

ARCHS = sorted(_MODULES)


def get_config(name: str, smoke: bool = False):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCHS}")
    mod = _MODULES[name]
    return mod.SMOKE if smoke else mod.CONFIG
