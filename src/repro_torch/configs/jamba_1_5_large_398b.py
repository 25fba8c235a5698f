"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8) d_ff=24576.

vocab=65536, Mamba+attention 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887; hf]. Layout: 9 super-blocks of 8 layers; within each
block, one layer is attention (in-block index attn_every // 2 = 4, as the
model code places it), the other 7 are Mamba; MoE replaces the FFN on
every other layer (odd in-block indices).
A copy of the reference package's config of the same name.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,                # per-expert hidden
    vocab_size=65_536,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    rope_theta=10_000.0,
    attn_every=8,
    moe=MoEConfig(num_experts=16, top_k=2, num_shared_experts=0,
                  layout="every_2"),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="jamba-smoke",
        family="hybrid",
        num_layers=8,          # one super-block
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=64,
        vocab_size=256,
        mlp_kind="swiglu",
        norm_kind="rmsnorm",
        rope_theta=10_000.0,
        attn_every=8,
        moe=MoEConfig(num_experts=4, top_k=2, num_shared_experts=0,
                      layout="every_2"),
        ssm=SSMConfig(d_state=4, d_conv=4, expand=2),
        dtype="float32",
    )
