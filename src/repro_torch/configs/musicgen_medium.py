"""musicgen-medium [audio]: 48L d_model=1536 24H (GQA kv=24) d_ff=6144 vocab=2048.

Decoder-only LM over EnCodec tokens [arXiv:2306.05284; hf]. The EnCodec
frontend is a STUB: the model takes precomputed frame embeddings
(`batch["embeds"]`). A copy of the reference package's config of the same
name.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    mlp_kind="gelu",
    norm_kind="layernorm",
    rope_theta=10_000.0,
    embed_inputs=True,   # frame embeddings from the (stubbed) EnCodec frontend
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium-smoke",
        family="audio",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=128,
        mlp_kind="gelu",
        norm_kind="layernorm",
        rope_theta=10_000.0,
        embed_inputs=True,
        dtype="float32",
    )
