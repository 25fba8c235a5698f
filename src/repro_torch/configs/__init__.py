from repro_torch.configs.base import (
    ARCH_IDS,
    LONG_CONTEXT_ARCHS,
    SHAPES,
    ModelConfig,
    MoEConfig,
    OptimizerConfig,
    RWKVConfig,
    ShapeConfig,
    SparseUpdateConfig,
    SSMConfig,
    TrainConfig,
    all_cells,
    cell_is_skipped,
    get_config,
    get_smoke_config,
)

__all__ = [
    "ARCH_IDS", "LONG_CONTEXT_ARCHS", "SHAPES", "ModelConfig", "MoEConfig",
    "OptimizerConfig", "RWKVConfig", "ShapeConfig", "SparseUpdateConfig",
    "SSMConfig", "TrainConfig", "all_cells", "cell_is_skipped", "get_config",
    "get_smoke_config",
]
