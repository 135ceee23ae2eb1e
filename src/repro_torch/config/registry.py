"""Architecture registry of the port: ``get_config("qwen3-4b")``.

Counterpart of :mod:`repro.config.registry`, limited to the architectures
the port builds.  Asking for any other raises a ``KeyError`` that names
what is ported.
"""
from __future__ import annotations

import importlib
from typing import Callable

from .base import ModelConfig

_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}

#: ported architecture ids -> config module under repro_torch.configs
ARCH_MODULES = {
    "qwen3-4b": "qwen3_4b",
}


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_config(name: str, *, smoke: bool = False) -> ModelConfig:
    mod = ARCH_MODULES.get(name)
    if mod is None:
        raise KeyError(f"arch {name!r} is not ported to repro_torch yet; "
                       f"ported: {sorted(ARCH_MODULES)}")
    importlib.import_module(f"repro_torch.configs.{mod}")
    return _REGISTRY[f"{name}:smoke" if smoke else name]()


def list_configs() -> list[str]:
    return sorted(ARCH_MODULES)
