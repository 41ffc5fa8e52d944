"""Architecture and shape configs: the reference's ``repro.configs``,
copied field for field (data and arithmetic only)."""
from repro_torch.configs.base import (
    ARCH_MODULES, ModelConfig, SHAPES, ShapeConfig, all_cells, get_config,
    list_archs, register,
)
__all__ = ["ARCH_MODULES", "ModelConfig", "SHAPES", "ShapeConfig",
           "all_cells", "get_config", "list_archs", "register"]
