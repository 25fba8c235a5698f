"""llama4-scout-17b-a16e [moe]: 48L d_model=5120 40H (GQA kv=8) d_ff=8192.

vocab=202048, MoE 16 routed experts top-1 + 1 shared expert, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]. Every layer MoE.
A copy of the reference package's config of the same name.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,                 # per-expert hidden
    vocab_size=202_048,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    rope_theta=500_000.0,
    moe=MoEConfig(num_experts=16, top_k=1, num_shared_experts=1, layout="all"),
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-smoke",
        family="moe",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=64,
        vocab_size=256,
        mlp_kind="swiglu",
        norm_kind="rmsnorm",
        rope_theta=500_000.0,
        moe=MoEConfig(num_experts=4, top_k=1, num_shared_experts=1, layout="all"),
        dtype="float32",
    )
