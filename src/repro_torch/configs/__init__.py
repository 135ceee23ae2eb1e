"""Architecture configs the port builds (one module per arch)."""
from ..config.registry import ARCH_MODULES, get_config, list_configs  # noqa: F401
