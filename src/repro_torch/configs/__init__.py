"""Architecture registry: the ten assigned configs (+ smoke variants).

``get_config(arch_id)`` / ``get_smoke(arch_id)`` resolve the exact
published configuration / its reduced smoke-test sibling; ``ARCHS``
lists every selectable ``--arch`` id, in the reference's order.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import LM_SHAPES, ModelConfig, ShapeSpec

__all__ = ["ARCHS", "LM_SHAPES", "get_config", "get_smoke", "get_shapes"]

_MODULES: Dict[str, str] = {
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "hymba-1.5b": "hymba_1_5b",
    "mamba2-1.3b": "mamba2_1_3b",
    "starcoder2-3b": "starcoder2_3b",
    "qwen1.5-110b": "qwen1_5_110b",
    "gemma-7b": "gemma_7b",
    "starcoder2-7b": "starcoder2_7b",
    "chameleon-34b": "chameleon_34b",
    "whisper-tiny": "whisper_tiny",
}

ARCHS: List[str] = list(_MODULES.keys())


def _mod(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _mod(arch).CONFIG


def get_smoke(arch: str) -> ModelConfig:
    return _mod(arch).SMOKE


def get_shapes(arch: str) -> Dict[str, ShapeSpec]:
    return dict(LM_SHAPES)
