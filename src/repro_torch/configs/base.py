"""Config system: dataclass model configs, input shapes and the sparse-update
and optimizer knobs.

A copy of the reference package's `configs/base.py` (the port imports
nothing of the reference). Field names and defaults are kept identical, so a
config built here means the same model and the same training run as its
counterpart there. Architectures are registered as their slices land.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, field
from typing import Optional


# ---------------------------------------------------------------------------
# Model configs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MoEConfig:
    num_experts: int              # routed experts
    top_k: int
    num_shared_experts: int = 0   # always-on experts (deepseek/llama4 style)
    capacity_factor: float = 1.25
    # which layers are MoE: "all", "every_2", "all_but_first"
    layout: str = "all"


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-1 block config (jamba)."""
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2


@dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int                # query heads (0 for attn-free)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // num_heads
    mlp_kind: str = "swiglu"      # swiglu | sq_relu | gelu
    norm_kind: str = "rmsnorm"    # rmsnorm | layernorm
    rope_theta: float = 1e6
    attn_pattern: str = "full"
    sliding_window: int = 0
    attn_every: int = 0
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    tie_embeddings: bool = False
    embed_inputs: bool = False
    mrope: bool = False
    dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        assert self.num_heads > 0
        return self.d_model // self.num_heads


# ---------------------------------------------------------------------------
# Input shapes (seq_len x global_batch)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode


# architectures the port runs so far
_MODULES = {
    "llama3-8b": "llama3_8b",
    "deepseek-moe-16b": "deepseek_moe_16b",
}


def _arch_module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"architecture {arch_id!r} is not ported yet; "
                       f"the port runs {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    return _arch_module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _arch_module(arch_id).smoke_config()


# ---------------------------------------------------------------------------
# Training / sparse-update config (the paper's knobs)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SparseUpdateConfig:
    """Algorithm 1 knobs + channel-block granularity."""
    enabled: bool = True
    update_ratio: float = 0.2          # r: fraction of channel blocks per layer
    num_update_layers: int = 0         # K: last-K blocks trainable (0 = solve from budget)
    memory_budget_bytes: int = 0       # M: per-device budget (0 = no constraint)
    channel_block: int = 128           # selection granularity
    phase_fixed_early: int = 10        # j
    phase_dynamic: int = 20            # k
    phase_fixed_late: int = 20         # l
    seed: int = 0
    update_embeddings: bool = False    # embeddings/lm_head frozen by default
    update_norms: bool = False


@dataclass(frozen=True)
class OptimizerConfig:
    kind: str = "sgd"                  # sgd | momentum | adamw  (paper: sgd m=0)
    learning_rate: float = 0.1
    momentum: float = 0.0
    weight_decay: float = 0.0
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    warmup_steps: int = 0
    decay_steps: int = 0               # cosine decay horizon (0 = constant)
    grad_clip: float = 0.0


@dataclass(frozen=True)
class TrainConfig:
    model: ModelConfig
    shape: ShapeConfig
    sparse: SparseUpdateConfig = field(default_factory=SparseUpdateConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    steps: int = 100
    log_every: int = 10
    checkpoint_every: int = 50
    checkpoint_dir: str = ""
    keep_checkpoints: int = 3
    remat: str = "selected"            # none | selected | full
    # compact-gradient path: the compact per-block dW goes through clipping,
    # the optimizer and the update without a full-shape dW ever existing
    compact_grads: bool = False
    seed: int = 0

