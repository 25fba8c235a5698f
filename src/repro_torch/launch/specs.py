"""Dry-run plumbing on one device: abstract inputs, caches and the step
functions of every (arch x shape) cell, as tensors on the `meta` device
(or on a device the caller names).

The single-device half of the reference's `launch/specs.py`: its sharding
half (`resolve_pspec`, `tree_shardings`, `batch_shardings`,
`cache_shardings`, `state_shardings`, `rules_for`) waits for the port's
multi-GPU slice (ROADMAP item 14). On `meta` nothing is allocated and every
kernel wrapper takes its plain path, so a cell of any size builds and runs
here for its shapes and FLOPs. Modality frontends ([audio] / [vlm]) are
stubs, as in the reference: the batch carries frame / patch embeddings.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs.base import (ModelConfig, OptimizerConfig,
                                      ShapeConfig, SparseUpdateConfig,
                                      TrainConfig)
from repro_torch.models import decoding as D
from repro_torch.models import transformer as T


def _empty(shape, dtype, device):
    return torch.empty(shape, dtype=dtype, device=device)


def input_specs(cfg: ModelConfig, shape: ShapeConfig, device="meta") -> dict:
    """The batch of a cell (train / prefill: the full sequence; decode: one
    token, its positions at the cache's end), uninitialized on `device`."""
    b = shape.global_batch
    s = shape.seq_len if shape.kind != "decode" else 1
    batch: dict[str, Any] = {}
    if cfg.embed_inputs:
        batch["embeds"] = _empty((b, s, cfg.d_model), T.dtype_of(cfg), device)
    else:
        batch["tokens"] = _empty((b, s), torch.int32, device)
    if shape.kind == "train":
        batch["labels"] = _empty((b, s), torch.int32, device)
    if cfg.mrope:
        batch["positions"] = _empty((3, b, s), torch.int32, device)
    elif shape.kind == "decode":
        batch["positions"] = _empty((b, s), torch.int32, device)
    return batch


def cache_abstract(cfg: ModelConfig, shape: ShapeConfig, device="meta"):
    """The stacked contiguous cache of a decode cell ([steps, batch, ...]
    per leaf) on `device`."""
    return D.init_cache(cfg, shape.global_batch, shape.seq_len, device)


def _default_k(cfg: ModelConfig) -> int:
    """Default: train the last quarter of the stacked steps (the paper's
    as-many-later-layers-as-fit; budget solving is exercised separately)."""
    total = sum(s.steps for s in T.segment_layout(cfg))
    return max(1, total // 4)


def make_train_cell(cfg: ModelConfig, shape: ShapeConfig,
                    sparse: Optional[SparseUpdateConfig] = None,
                    optimizer: Optional[OptimizerConfig] = None,
                    device="meta", seed: int = 0):
    """(step_fn, state, batch, plan) of a training cell: the reference's
    defaults (r = 0.2, the last quarter of the steps, blocks of 128, SGD
    at 0.01), a random first selection (magnitude needs real weights), and
    the compact step when the update is sparse. On `meta` the state and
    batch are shapes only; elsewhere the params are random from `seed` and
    the batch uninitialized."""
    from repro_torch.train.steps import make_train_state, make_train_step

    sparse = sparse if sparse is not None else SparseUpdateConfig(
        update_ratio=0.2, num_update_layers=_default_k(cfg),
        channel_block=128)
    optimizer = optimizer or OptimizerConfig(
        kind="sgd", learning_rate=0.01, warmup_steps=100, decay_steps=10_000)
    tc = TrainConfig(model=cfg, shape=shape, sparse=sparse,
                     optimizer=optimizer, compact_grads=sparse.enabled,
                     seed=seed)
    state, plan = make_train_state(tc, selection_init="random",
                                   device=device)
    step_fn = make_train_step(tc, plan)
    return step_fn, state, input_specs(cfg, shape, device), plan


def make_decode_cell(cfg: ModelConfig, shape: ShapeConfig, device="meta",
                     seed: int = 0):
    """(serve_step, (params, batch, cache)): one new token against a
    seq_len cache."""
    params = T.init_params(cfg, seed, device)

    def serve_step(params, batch, cache):
        return D.decode_step(cfg, params, batch, cache)

    return serve_step, (params, input_specs(cfg, shape, device),
                        cache_abstract(cfg, shape, device))


def make_prefill_cell(cfg: ModelConfig, shape: ShapeConfig, device="meta",
                      seed: int = 0):
    """(prefill_step, (params, batch)): the whole prompt, returning the
    last token's logits and the filled cache."""
    params = T.init_params(cfg, seed, device)

    def prefill_step(params, batch):
        return D.prefill(cfg, params, batch)

    return prefill_step, (params, input_specs(cfg, shape, device))
