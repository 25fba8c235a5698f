"""command-r-35b [dense]: 40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000.

GQA, no-bias [hf:CohereForAI/c4ai-command-r-v01; unverified].
A copy of the reference package's config of the same name.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22528,
    vocab_size=256_000,
    mlp_kind="swiglu",
    norm_kind="layernorm",   # cohere uses LN (no-bias handled in layers)
    rope_theta=8e6,
    tie_embeddings=True,     # command-r ties input/output embeddings
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="command-r-35b-smoke",
        family="dense",
        num_layers=3,
        d_model=64,
        num_heads=8,
        num_kv_heads=2,
        d_ff=160,
        vocab_size=256,
        mlp_kind="swiglu",
        norm_kind="layernorm",
        rope_theta=8e6,
        tie_embeddings=True,
        dtype="float32",
    )
