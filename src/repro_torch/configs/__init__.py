from repro_torch.configs.base import (
    ARCH_IDS,
    ArchConfig,
    MoEConfig,
    SHAPES,
    ShapeConfig,
    get_config,
    smoke_config,
)

__all__ = [
    "ARCH_IDS",
    "ArchConfig",
    "MoEConfig",
    "SHAPES",
    "ShapeConfig",
    "get_config",
    "smoke_config",
]
