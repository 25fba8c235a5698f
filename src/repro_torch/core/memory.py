"""Per-device training-memory model — the paper's 256KB budget, scaled.

Estimates the extra memory backprop needs: saved activations of the
trainable layers plus gradient and optimizer-state buffers of the selected
params. Frozen front layers contribute nothing (their activations are never
kept) — the paper's feature-memory saving. The model is analytic and runs
before anything is allocated; shapes come from the `meta`-device params.
"""
from __future__ import annotations

import warnings

from repro_torch.configs.base import ModelConfig, SparseUpdateConfig
from repro_torch.core.sparse_update import tree_leaves


def _bytes(dtype: str) -> int:
    return {"bfloat16": 2, "float32": 4, "float16": 2}[dtype]


def activation_bytes_per_layer(cfg: ModelConfig, tokens_per_device: int) -> int:
    """Saved-for-backward bytes per trainable layer under per-layer remat
    (the layer input [B,S,d] kept as the recompute checkpoint). Dense
    family: one layer per stacked step."""
    return tokens_per_device * cfg.d_model * _bytes(cfg.dtype)


def trainable_param_bytes(cfg: ModelConfig, sp: SparseUpdateConfig,
                          k_steps: int) -> dict:
    """Gradient + optimizer-state bytes for the last k_steps trainable layers
    with channel ratio r (only selected blocks are optimizer-tracked)."""
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import abstract_params

    abs_params = abstract_params(cfg)
    by = _bytes(cfg.dtype)
    remaining = k_steps
    grad_full = 0
    grad_sel = 0
    for seg in reversed(T.segment_layout(cfg)):
        take = min(seg.steps, remaining)
        remaining -= take
        if take == 0:
            continue
        stack = abs_params["segments"][seg.name]
        per_step = sum(x.numel() for x in tree_leaves(stack)) // seg.steps
        grad_full += per_step * take
        grad_sel += int(per_step * take * sp.update_ratio)
    return {
        "grad_bytes_full": grad_full * by,
        "grad_bytes_selected": grad_sel * by,
        "opt_bytes_selected": grad_sel * by,   # 1x for momentum; 0 for sgd
    }


def training_extra_bytes(cfg: ModelConfig, sp: SparseUpdateConfig,
                         k_steps: int, tokens_per_device: int,
                         optimizer_slots: int = 0) -> int:
    """The paper's 'extra memory' for one update iteration."""
    act = activation_bytes_per_layer(cfg, tokens_per_device) * k_steps
    tp = trainable_param_bytes(cfg, sp, k_steps)
    return (act + tp["grad_bytes_selected"]
            + tp["opt_bytes_selected"] * optimizer_slots)


def solve_max_layers(cfg: ModelConfig, sp: SparseUpdateConfig,
                     tokens_per_device: int, optimizer_slots: int = 0,
                     *, strict: bool = False) -> int:
    """Largest last-K whose extra memory fits sp.memory_budget_bytes — the
    paper's 'update as many (later) layers as the budget allows'.

    If even K=1 exceeds the budget it warns and returns 1 (training needs
    one trainable layer), or raises under ``strict=True``."""
    from repro_torch.models import transformer as T
    total = sum(s.steps for s in T.segment_layout(cfg))
    best = 0
    for k in range(1, total + 1):
        if training_extra_bytes(cfg, sp, k, tokens_per_device,
                                optimizer_slots) <= sp.memory_budget_bytes:
            best = k
        else:
            break
    if best == 0:
        need = training_extra_bytes(cfg, sp, 1, tokens_per_device,
                                    optimizer_slots)
        msg = (f"memory budget {sp.memory_budget_bytes}B cannot fit even one "
               f"trainable scan step of {cfg.name} (needs {need}B at "
               f"{tokens_per_device} tokens/device)")
        if strict:
            raise ValueError(msg)
        warnings.warn(msg + "; falling back to K=1 over budget", stacklevel=2)
        return 1
    return best
