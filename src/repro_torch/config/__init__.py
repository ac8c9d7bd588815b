from repro_torch.config.base import (
    ArchConfig,
    DataConfig,
    LoRAConfig,
    ModelConfig,
    SplitConfig,
    TrainConfig,
    reduced,
)

__all__ = [
    "ArchConfig",
    "DataConfig",
    "LoRAConfig",
    "ModelConfig",
    "SplitConfig",
    "TrainConfig",
    "reduced",
]
