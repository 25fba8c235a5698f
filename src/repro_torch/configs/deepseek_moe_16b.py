"""deepseek-moe-16b [moe]: 28L d_model=2048 16H (kv=16) d_ff=1408 vocab=102400.

2 shared + 64 routed experts, top-6, fine-grained [arXiv:2401.06066]. The
first layer is a dense FFN (d_ff 8 x 1408, `models.transformer`), the other
27 are MoE. A copy of the reference package's config of the same name.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,                 # per-expert hidden
    vocab_size=102_400,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    rope_theta=10_000.0,
    moe=MoEConfig(num_experts=64, top_k=6, num_shared_experts=2,
                  layout="all_but_first"),
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b-smoke",
        family="moe",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=32,
        vocab_size=256,
        mlp_kind="swiglu",
        norm_kind="rmsnorm",
        rope_theta=10_000.0,
        moe=MoEConfig(num_experts=8, top_k=2, num_shared_experts=2,
                      layout="all_but_first"),
        dtype="float32",
    )
