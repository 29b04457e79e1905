"""Assigned-architecture registry (counterpart of ``repro.configs``): one
module per arch.

Each module defines ``CONFIG`` (the exact assigned configuration) and
``SMOKE`` (a reduced same-family config for CPU tests).  Data only, with
the reference's values; ``param_dtype`` is a ``torch.dtype``.  The
input-shape helpers are in ``repro_torch.configs.shapes``.
"""
from importlib import import_module
from typing import Dict

from ..models import ModelConfig

_MODULES = {
    "recurrentgemma-9b": "recurrentgemma_9b",
    "whisper-medium": "whisper_medium",
    "qwen3-14b": "qwen3_14b",
    "yi-9b": "yi_9b",
    "phi3-medium-14b": "phi3_medium_14b",
    "qwen2.5-32b": "qwen2_5_32b",
    "mamba2-780m": "mamba2_780m",
    "mixtral-8x7b": "mixtral_8x7b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "qwen2-vl-72b": "qwen2_vl_72b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(_MODULES)}")
    mod = import_module(f".{_MODULES[arch]}", __name__)
    return mod.SMOKE if smoke else mod.CONFIG


def all_configs(smoke: bool = False) -> Dict[str, ModelConfig]:
    return {a: get_config(a, smoke) for a in ARCH_IDS}
