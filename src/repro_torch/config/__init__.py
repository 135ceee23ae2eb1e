from .base import (SHAPES, MLAConfig, MoEConfig, ModelConfig, RWKVConfig,
                   RunConfig, ShapeConfig, SSMConfig)
from .registry import get_config, list_configs, register

__all__ = [
    "SHAPES", "MLAConfig", "MoEConfig", "ModelConfig", "RWKVConfig",
    "RunConfig", "SSMConfig", "ShapeConfig", "get_config", "list_configs", "register",
]
