"""qwen2-vl-7b [vlm]: 28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.

M-RoPE, dynamic resolution [arXiv:2409.12191; hf]. The vision frontend is a
STUB: the model takes precomputed patch embeddings (`batch["embeds"]`) plus
3-component M-RoPE position ids [3, B, S] (temporal, height, width). A copy
of the reference package's config of the same name.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18944,
    vocab_size=152_064,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    rope_theta=1_000_000.0,
    embed_inputs=True,    # patch/text embeddings from the stub frontend
    mrope=True,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b-smoke",
        family="vlm",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        mlp_kind="swiglu",
        norm_kind="rmsnorm",
        rope_theta=1_000_000.0,
        embed_inputs=True,
        mrope=True,
        dtype="float32",
    )
