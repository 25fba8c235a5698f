"""llama3-8b [dense]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.

GQA, 128k vocab [arXiv:2407.21783].
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=128_256,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    rope_theta=500_000.0,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama3-8b-smoke",
        family="dense",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        mlp_kind="swiglu",
        norm_kind="rmsnorm",
        rope_theta=500_000.0,
        dtype="float32",
    )
