"""Architecture registry of the port: ``get_config("qwen3-4b")``.

Counterpart of :mod:`repro.config.registry`, with the same architectures:
the attention families (dense, vlm, audio, MoE, MLA), the Mamba2 hybrid
and RWKV.  An unknown name raises a ``KeyError`` that lists the known ones.
"""
from __future__ import annotations

import importlib
from typing import Callable

from .base import ModelConfig

_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}

#: architecture ids -> config module under repro_torch.configs
ARCH_MODULES = {
    "zamba2-1.2b": "zamba2_1p2b",
    "h2o-danube-3-4b": "h2o_danube3_4b",
    "qwen1.5-4b": "qwen1p5_4b",
    "qwen3-4b": "qwen3_4b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "pixtral-12b": "pixtral_12b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "rwkv6-3b": "rwkv6_3b",
    "musicgen-large": "musicgen_large",
}


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_config(name: str, *, smoke: bool = False) -> ModelConfig:
    mod = ARCH_MODULES.get(name)
    if mod is None:
        raise KeyError(f"unknown arch {name!r}; known: "
                       f"{sorted(ARCH_MODULES)}")
    importlib.import_module(f"repro_torch.configs.{mod}")
    return _REGISTRY[f"{name}:smoke" if smoke else name]()


def list_configs() -> list[str]:
    return sorted(ARCH_MODULES)
