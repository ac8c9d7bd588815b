from repro_torch.config.base import (
    ArchConfig,
    DataConfig,
    LoRAConfig,
    MeshConfig,
    ModelConfig,
    SHAPES,
    ShapeConfig,
    SplitConfig,
    TrainConfig,
    reduced,
)

__all__ = [
    "ArchConfig",
    "DataConfig",
    "LoRAConfig",
    "MeshConfig",
    "ModelConfig",
    "SHAPES",
    "ShapeConfig",
    "SplitConfig",
    "TrainConfig",
    "reduced",
]
