"""Architecture registry of the port: the dense configs it serves.

``get_config(arch_id)`` / ``get_smoke(arch_id)`` resolve the published
configuration / its reduced smoke-test sibling.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

_MODULES: Dict[str, str] = {
    "gemma-7b": "gemma_7b",
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
