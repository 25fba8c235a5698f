"""rwkv6-3b [ssm]: 32L d_model=2560 (attn-free) d_ff=8960 vocab=65536.

Finch — data-dependent decay [arXiv:2404.05892; hf]. head_dim=64 (40 heads).
A copy of the reference package's config of the same name.
"""
from repro_torch.configs.base import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    d_ff=8960,
    vocab_size=65_536,
    mlp_kind="rwkv_channel_mix",
    norm_kind="layernorm",
    rwkv=RWKVConfig(head_dim=64),
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b-smoke",
        family="ssm",
        num_layers=3,
        d_model=64,
        num_heads=0,
        num_kv_heads=0,
        d_ff=128,
        vocab_size=256,
        mlp_kind="rwkv_channel_mix",
        norm_kind="layernorm",
        rwkv=RWKVConfig(head_dim=16),
        dtype="float32",
    )
