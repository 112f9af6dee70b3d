"""Architecture registry: one module per assigned architecture.

Each module exposes CONFIG (the exact published configuration) and the
registry maps ``--arch <id>`` to it.  `smoke_config(id)` returns the reduced
same-family variant used by CPU smoke tests.  The configurations are the
JAX package's, copied as data; the port's model runs all ten
(`models/model.py`).
"""
from __future__ import annotations

from typing import Dict

from ..models.config import ModelConfig, reduced_for_smoke

from . import (granite_moe_3b_a800m, jamba_1_5_large_398b, musicgen_medium,
               nemotron_4_15b, pixtral_12b, qwen3_moe_235b_a22b, rwkv6_7b,
               tinyllama_1_1b, yi_34b, yi_9b)

_MODULES = {
    "rwkv6-7b": rwkv6_7b,
    "yi-34b": yi_34b,
    "tinyllama-1.1b": tinyllama_1_1b,
    "nemotron-4-15b": nemotron_4_15b,
    "yi-9b": yi_9b,
    "jamba-1.5-large-398b": jamba_1_5_large_398b,
    "pixtral-12b": pixtral_12b,
    "granite-moe-3b-a800m": granite_moe_3b_a800m,
    "qwen3-moe-235b-a22b": qwen3_moe_235b_a22b,
    "musicgen-medium": musicgen_medium,
}

ARCHS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCHS}")
    return _MODULES[arch].CONFIG


def smoke_config(arch: str) -> ModelConfig:
    return reduced_for_smoke(get_config(arch))


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCHS}
