"""Dry-run plumbing: abstract inputs, caches and the step functions of
every (arch x shape) cell, as tensors on the `meta` device (or on a device
the caller names), and the sharding of params, batches and train states on
a mesh.

On `meta` nothing is allocated and every kernel wrapper takes its plain
path, so a cell of any size builds and runs here for its shapes and FLOPs.
Modality frontends ([audio] / [vlm]) are stubs, as in the reference: the
batch carries frame / patch embeddings.

A sharding here is what the reference's `NamedSharding` holds: one entry
per dim, None (replicated) or a tuple of mesh axes the dim is split over.
`shard_local` cuts a full tree into one rank's slices by them (what placing
an array under a `NamedSharding` does in the reference) and
`gather_shards` puts the ranks' slices back together. `cache_shardings`
gives a contiguous decode cache's (kv heads over the model axis).
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs.base import (ModelConfig, OptimizerConfig,
                                      ShapeConfig, SparseUpdateConfig,
                                      TrainConfig)
from repro_torch.models import decoding as D
from repro_torch.models import transformer as T
from repro_torch.models.specs import param_logical_specs
from repro_torch.sharding import AxisRules, default_rules, seq_sharded_rules


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


# ---------------------------------------------------------------------------
# shardings
# ---------------------------------------------------------------------------

def resolve_pspec(shape: tuple, logical: tuple, rules: AxisRules) -> tuple:
    """Logical axes -> per-dim sharding (None or a tuple of mesh axes),
    with the reference's divisibility fallback: a dim its axes' sizes do
    not divide stays replicated."""
    out = []
    for dim, name in zip(shape, logical):
        axes = rules.rules.get(name) if name else None
        if axes is None:
            out.append(None)
            continue
        if isinstance(axes, str):
            axes = (axes,)
        size = 1
        for a in axes:
            size *= rules.mesh.shape[a]
        out.append(tuple(axes) if dim % size == 0 else None)
    return tuple(out)


def _is_logical(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(i, (str, type(None)))
                                        for i in x)


def tree_shardings(abs_tree, logical_tree, rules: AxisRules):
    """Sharding tree for a tree of tensors (any device, `meta` included)
    and its logical-axes tree. A leaf whose logical tuple is missing or of
    another rank is replicated."""
    if isinstance(abs_tree, dict):
        lt = logical_tree if isinstance(logical_tree, dict) else {}
        return {k: tree_shardings(v, lt.get(k), rules)
                for k, v in abs_tree.items()}
    if abs_tree is None:
        return None
    shape = tuple(abs_tree.shape)
    if not _is_logical(logical_tree) or len(logical_tree) != len(shape):
        logical_tree = (None,) * len(shape)
    return resolve_pspec(shape, logical_tree, rules)


def batch_shardings(cfg, shape: ShapeConfig, rules: AxisRules) -> dict:
    """The batch's keys -> shardings: the batch axis over the data axes."""
    def spec_for(key, leaf):
        if key == "positions" and cfg.mrope:
            return resolve_pspec(leaf.shape, (None, "batch", None), rules)
        return resolve_pspec(leaf.shape, ("batch",) + (None,) *
                             (len(leaf.shape) - 1), rules)
    return {k: spec_for(k, v)
            for k, v in input_specs(cfg, shape, "meta").items()}


def state_shardings(cfg, plan, state_abs, rules: AxisRules) -> dict:
    """Shardings of a train state's tensors: params and optimizer state by
    their leaves' logical axes; `sel_idx` as the plan lays it out (its
    shard axis over the model axis where the weight's out dim is split, as
    the rank keeps it: `core.selection.local_selection`). `step` and `rng`
    are host values."""
    logical = param_logical_specs(cfg)
    sh = {"params_trainable": tree_shardings(state_abs["params_trainable"],
                                             logical, rules),
          "params_frozen": tree_shardings(state_abs["params_frozen"],
                                          logical, rules),
          "opt": {k: tree_shardings(v, logical, rules)
                  for k, v in (state_abs["opt"] or {}).items()}}
    from repro_torch.core.sparse_update import SelSpec

    def sel(spec, idx):
        if isinstance(spec, SelSpec):
            model = (rules.model_axis,) if spec.n_shards > 1 else None
            return (None, model, None)
        return {k: sel(spec[k], idx[k]) for k in spec}
    sh["sel_idx"] = None if state_abs["sel_idx"] is None else {
        seg: (None if idx is None else sel(plan.spec[seg], idx))
        for seg, idx in state_abs["sel_idx"].items()}
    return sh


def rules_for(mesh, cfg: ModelConfig, shape: ShapeConfig) -> AxisRules:
    """Sharding rules per cell, the reference's: batch over the batch axes,
    tensor / expert / vocab parallelism over the model axis, kv heads
    replicated (head counts rarely divide the model axis; the GQA
    expansion then reads the rank's own query heads' kv heads), the kv
    cache's sequence over the model axis for decode and prefill, and for
    long_500k (batch 1) over the batch axes too."""
    r = seq_sharded_rules(mesh) if shape.name == "long_500k" \
        else default_rules(mesh)
    rules = dict(r.rules)
    rules["kv_heads"] = None
    if shape.kind in ("decode", "prefill"):
        prev = rules.get("cache_seq")
        prev_axes = (prev,) if isinstance(prev, str) else tuple(prev or ())
        model = (r.model_axis,) if r.model_axis else ()
        rules["cache_seq"] = prev_axes + model or None
    return AxisRules(rules, mesh=r.mesh, batch_axes=r.batch_axes,
                     model_axis=r.model_axis)


def _dim_slice(size: int, axes, mesh_shape: dict, coords: dict) -> slice:
    if axes is None:
        return slice(None)
    n, i = 1, 0
    for a in axes:
        n *= mesh_shape[a]
        i = i * mesh_shape[a] + coords[a]
    step = size // n
    return slice(i * step, (i + 1) * step)


def shard_leaf(x, sharding, mesh_shape: dict, coords: dict):
    """One rank's slice of a full tensor or array (a view)."""
    if sharding is None:
        return x
    index = tuple(_dim_slice(size, axes, mesh_shape, coords)
                  for size, axes in zip(x.shape, sharding))
    return x[index]


def shard_local(tree, shardings, mesh_shape: dict, coords: dict):
    """A full tree (numpy arrays or tensors) -> the rank at `coords`'
    slices (views), by a `tree_shardings`-shaped tree."""
    if isinstance(tree, dict):
        return {k: shard_local(v, shardings[k], mesh_shape, coords)
                for k, v in tree.items()}
    if tree is None:
        return None
    return shard_leaf(tree, shardings, mesh_shape, coords)


def gather_shards(trees: list, coords: list, shardings, mesh_shape: dict):
    """The inverse of shard_local: the ranks' slice trees (numpy arrays,
    with each rank's coords) -> the full tree. A replicated dim is read
    from the ranks at coordinate 0 on its axes."""
    import numpy as np

    if isinstance(trees[0], dict):
        return {k: gather_shards([t[k] for t in trees], coords,
                                 shardings[k], mesh_shape)
                for k in trees[0]}
    if trees[0] is None:
        return None
    sharding = shardings or (None,) * trees[0].ndim
    split = {a for axes in sharding if axes for a in axes}
    parts = {}
    for t, c in zip(trees, coords):
        if any(c[a] for a in mesh_shape if a not in split):
            continue
        parts[tuple(c[a] for a in mesh_shape if a in split)] = t

    def build(dim: int, fixed: dict):
        if dim == len(sharding):
            return parts[tuple(fixed[a] for a in mesh_shape if a in split)]
        axes = sharding[dim]
        if axes is None:
            return build(dim + 1, fixed)
        import itertools
        pieces = [build(dim + 1, {**fixed, **dict(zip(axes, combo))})
                  for combo in itertools.product(
                      *(range(mesh_shape[a]) for a in axes))]
        return np.concatenate(pieces, axis=dim)
    return build(0, {})


# ---------------------------------------------------------------------------
# cache shardings
# ---------------------------------------------------------------------------

_CACHE_LOGICAL = {
    "k": ("layers", "batch", "cache_seq", "kv_heads", None),
    "v": ("layers", "batch", "cache_seq", "kv_heads", None),
    "pos": ("layers", "batch"),
    "h": ("layers", "batch", "d_inner", None),
    "conv": ("layers", "batch", None, "d_inner"),
    "s": ("layers", "batch", None, None, None),
    "last": ("layers", "batch", None),
}


def cache_shardings(cfg, cache_abs, rules: AxisRules):
    """Sharding tree of a stacked contiguous cache (`cache_abstract`): each
    leaf by its name's logical axes; a leaf of another rank, or another
    name, only its layers axis named (replicated)."""
    def walk(node):
        if isinstance(node, dict):
            return {k: (walk(v) if isinstance(v, dict) else _leaf(k, v))
                    for k, v in node.items()}
        return node

    def _leaf(name, leaf):
        logical = _CACHE_LOGICAL.get(name)
        if logical is None or len(logical) != len(leaf.shape):
            logical = ("layers",) + (None,) * (len(leaf.shape) - 1)
        return resolve_pspec(tuple(leaf.shape), logical, rules)
    return walk(cache_abs)
