"""nemotron-4-15b [dense]: 32L d_model=6144 48H (GQA kv=8) d_ff=24576 vocab=256000.

GQA, squared-ReLU MLP [arXiv:2402.16819; unverified].
A copy of the reference package's config of the same name.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    num_layers=32,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=256_000,
    mlp_kind="sq_relu",
    norm_kind="layernorm",
    rope_theta=10_000.0,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-15b-smoke",
        family="dense",
        num_layers=3,
        d_model=64,
        num_heads=8,
        num_kv_heads=2,
        d_ff=192,
        vocab_size=256,
        mlp_kind="sq_relu",
        norm_kind="layernorm",
        rope_theta=10_000.0,
        dtype="float32",
    )
