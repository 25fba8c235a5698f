from repro_torch.configs.base import (
    ModelConfig,
    MoEConfig,
    OptimizerConfig,
    RWKVConfig,
    ShapeConfig,
    SparseUpdateConfig,
    SSMConfig,
    TrainConfig,
    get_config,
    get_smoke_config,
)

__all__ = [
    "ModelConfig", "MoEConfig", "OptimizerConfig", "RWKVConfig",
    "ShapeConfig", "SparseUpdateConfig", "SSMConfig", "TrainConfig",
    "get_config", "get_smoke_config",
]
