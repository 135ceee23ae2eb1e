from .base import (MLAConfig, MoEConfig, ModelConfig, RWKVConfig, RunConfig,
                   SSMConfig)
from .registry import get_config, list_configs, register

__all__ = [
    "MLAConfig", "MoEConfig", "ModelConfig", "RWKVConfig", "RunConfig",
    "SSMConfig", "get_config", "list_configs", "register",
]
