"""gemma3-4b [dense]: 34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144.

5:1 local:global attention, 128k context [hf:google/gemma-3-1b-pt; unverified].
head_dim derived = 320. Sliding window 1024 on local layers.

Layer layout: 5 super-blocks of (5 local + 1 global) = 30 layers, then 4
local layers (34 total); globals at depths 5, 11, 17, 23, 29.
A copy of the reference package's config of the same name.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    num_layers=34,
    d_model=2560,
    num_heads=8,
    num_kv_heads=4,
    d_ff=10240,
    vocab_size=262_144,
    mlp_kind="gelu",
    norm_kind="rmsnorm",
    rope_theta=1_000_000.0,
    attn_pattern="local_global:5:1",
    sliding_window=1024,
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-4b-smoke",
        family="dense",
        num_layers=6,          # one local:global period
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        mlp_kind="gelu",
        norm_kind="rmsnorm",
        rope_theta=1_000_000.0,
        attn_pattern="local_global:5:1",
        sliding_window=16,
        tie_embeddings=True,
        dtype="float32",
    )
