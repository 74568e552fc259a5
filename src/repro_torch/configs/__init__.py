"""Architecture registry: the 10 assigned archs + the paper's bench config.

Each module exposes CONFIG (exact published dims) and SMOKE (reduced config
of the same family for CPU tests).  ``get_config(name)`` / ``list_archs()``
are the public API; ``--arch <id>`` on every launcher resolves here.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig

_ARCH_MODULES = {
    "smollm-135m": "smollm_135m",
    "gemma3-27b": "gemma3_27b",
    "qwen3-14b": "qwen3_14b",
    "stablelm-3b": "stablelm_3b",
    "zamba2-2.7b": "zamba2_2_7b",
    "arctic-480b": "arctic_480b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "llama-3.2-vision-11b": "llama32_vision_11b",
    "whisper-tiny": "whisper_tiny",
}


def list_archs() -> List[str]:
    return list(_ARCH_MODULES)


def _module(name: str):
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {list_archs()}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).SMOKE


def shapes_for(name: str) -> List[ShapeConfig]:
    """The assigned shape cells for this arch (with documented skips)."""
    cfg = get_config(name)
    out = []
    for s in SHAPES.values():
        if s.name == "long_500k" and not cfg.supports_long_context:
            continue  # pure full-attention: no sub-quadratic path (DESIGN §4)
        out.append(s)
    return out
