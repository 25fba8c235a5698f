"""Layer/channel selection (paper §III-B.1).

Later layers first, with a constant channel-block update ratio r, sized so
the backward working set fits the memory budget M. No target-dataset
statistics are used. Channels are selected in blocks, equally many per
output shard of each weight (the paper's equal-sparsity-per-PE rule); the
port runs one shard until its multi-GPU slice.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig, SparseUpdateConfig
from repro_torch.core import memory as memmod
from repro_torch.core.sparse_update import SelSpec, tree_leaves
from repro_torch.models import transformer as T
from repro_torch.models.registry import abstract_params

# weight leaves that take part in channel selection (out-channel blocks)
SELECTABLE = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
              "in_proj", "out_proj", "wg", "wr"}
# excluded even though matmul-shaped: tiny recurrence/router params
EXCLUDED = {"router", "x_proj", "dt_proj", "A_log", "wA", "wB", "mu", "u",
            "w0", "conv_w"}


@dataclass(frozen=True)
class SelectionPlan:
    """Static plan: trainable trailing layers per segment and the
    channel-block spec of every selectable weight leaf."""
    seg_trainable: dict[str, int]          # segment -> trailing steps trainable
    spec: dict[str, Any]                   # segment -> nested {leaf: SelSpec}
    update_ratio: float
    channel_block: int
    seed: int
    update_embeddings: bool = False

    def total_steps(self) -> int:
        return sum(self.seg_trainable.values())


def _largest_divisor_leq(n: int, k: int) -> int:
    for d in range(min(n, k), 0, -1):
        if n % d == 0:
            return d
    return 1


def _build_spec_tree(seg_stack_abs, ratio: float, block_req: int) -> dict:
    """Walk a segment's abstract stacked params; SelSpec per selectable leaf."""
    out = {}
    for name, sub in seg_stack_abs.items():
        if isinstance(sub, dict):
            child = _build_spec_tree(sub, ratio, block_req)
            if child:
                out[name] = child
            continue
        if name in EXCLUDED or name not in SELECTABLE or sub.dim() < 3:
            continue  # dim<3: a stacked 1-D param, not a matmul weight
        n_shards = 1
        loc = sub.shape[-1] // n_shards
        block = _largest_divisor_leq(loc, block_req)
        n_blocks = loc // block
        n_sel = max(1, int(round(ratio * n_blocks)))
        out[name] = SelSpec(block=block, n_shards=n_shards, n_sel=n_sel,
                            n_blocks=n_blocks)
    return out


def build_plan(cfg: ModelConfig, sp: SparseUpdateConfig,
               per_device_batch_tokens: int = 0) -> SelectionPlan:
    """Build the selection plan. If sp.num_update_layers == 0, solve the
    largest last-K under sp.memory_budget_bytes via the memory model."""
    segs = T.segment_layout(cfg)
    abs_params = abstract_params(cfg)
    spec = {seg.name: _build_spec_tree(abs_params["segments"][seg.name],
                                       sp.update_ratio, sp.channel_block)
            for seg in segs}

    total_steps = sum(s.steps for s in segs)
    if sp.num_update_layers > 0:
        k_steps = min(sp.num_update_layers, total_steps)
    elif sp.memory_budget_bytes > 0:
        k_steps = memmod.solve_max_layers(cfg, sp, per_device_batch_tokens)
    else:
        k_steps = total_steps

    # trainable steps from the END (later layers first — paper)
    seg_trainable = {}
    remaining = k_steps
    for seg in reversed(segs):
        take = min(seg.steps, remaining)
        seg_trainable[seg.name] = take
        remaining -= take
    return SelectionPlan(seg_trainable=seg_trainable, spec=spec,
                         update_ratio=sp.update_ratio,
                         channel_block=sp.channel_block, seed=sp.seed,
                         update_embeddings=sp.update_embeddings)


# ---------------------------------------------------------------------------
# index generation
# ---------------------------------------------------------------------------

def _spec_leaves(spec_tree, prefix: str = "") -> list[tuple[str, SelSpec]]:
    """(path, SelSpec) of every selectable leaf, in key order."""
    out = []
    for name, sub in spec_tree.items():
        path = f"{prefix}/{name}"
        if isinstance(sub, SelSpec):
            out.append((path, sub))
        else:
            out.extend(_spec_leaves(sub, path))
    return out


def _set_path(tree: dict, path: str, value) -> None:
    keys = path.strip("/").split("/")
    for key in keys[:-1]:
        tree = tree.setdefault(key, {})
    tree[keys[-1]] = value


def draw_seed(seed: int, step: int, segment: str, leaf: str) -> int:
    """The generator seed of one draw: a pure function of (seed, step,
    segment, leaf), stable across processes (crc32, not hash())."""
    return zlib.crc32(f"{seed}/{step}/{segment}/{leaf}".encode())


def random_selection(plan: SelectionPlan, seed: int, step: int,
                     device="cuda") -> dict:
    """Fresh random channel-block selection, drawn on `device` (used every
    step of the dynamic phase). Each leaf draws from its own generator,
    seeded by (seed, step, segment, leaf), so a draw depends on nothing
    carried across steps and a resumed run draws the same. Returns the idx
    tree: segment -> nested {leaf: int32 [K, n_shards, n_sel]}."""
    idx = {}
    for seg_name, steps in plan.seg_trainable.items():
        if steps == 0:
            idx[seg_name] = None
            continue
        tree: dict = {}
        for path, sp in _spec_leaves(plan.spec[seg_name]):
            gen = torch.Generator(device=device).manual_seed(
                draw_seed(seed, step, seg_name, path))
            u = torch.rand((steps, sp.n_shards, sp.n_blocks), generator=gen,
                           device=device)
            order = torch.argsort(u, dim=-1)
            _set_path(tree, path, order[..., : sp.n_sel].to(torch.int32))
        idx[seg_name] = tree
    return idx


def magnitude_selection(plan: SelectionPlan, params) -> dict:
    """Initial selection: per shard, the n_sel blocks with the largest weight
    L2 norm (the paper's offline importance — no target data needed)."""
    idx = {}
    for seg_name, steps in plan.seg_trainable.items():
        if steps == 0:
            idx[seg_name] = None
            continue
        stack = params["segments"][seg_name]
        k_slice = lambda a: a[a.shape[0] - steps:]
        idx[seg_name] = _magnitude_tree(plan.spec[seg_name], stack, k_slice)
    return idx


def _magnitude_tree(spec_tree, stack, k_slice):
    out = {}
    for name, sub in spec_tree.items():
        if isinstance(sub, dict):
            out[name] = _magnitude_tree(sub, stack[name], k_slice)
            continue
        sp: SelSpec = sub
        w = k_slice(stack[name])                       # [K, ..., out]
        k = w.shape[0]
        wb = w.reshape(k, -1, sp.n_shards, sp.n_blocks, sp.block)
        norms = torch.sqrt((wb.float() ** 2).sum(dim=(1, 4)))
        # stable, as jnp.argsort: ties keep the lower block index first
        order = torch.argsort(-norms, dim=-1, stable=True)
        out[name] = order[..., : sp.n_sel].to(torch.int32)
    return out


def selected_fraction(plan: SelectionPlan, cfg) -> float:
    """Fraction of total params updated per iteration (paper: ~2%)."""
    abs_params = abstract_params(cfg)
    total = sum(x.numel() for x in tree_leaves(abs_params))
    upd = 0
    for seg_name, steps in plan.seg_trainable.items():
        if steps == 0:
            continue
        upd += _selected_params(plan.spec[seg_name],
                                abs_params["segments"][seg_name], steps)
    return upd / total


def _selected_params(spec_tree, stack, steps) -> int:
    n = 0
    for name, sub in spec_tree.items():
        if isinstance(sub, dict):
            n += _selected_params(sub, stack[name], steps)
            continue
        sp: SelSpec = sub
        leaf = stack[name]
        per_step = leaf.numel() // leaf.shape[0]
        n += int(per_step * steps * (sp.n_sel / sp.n_blocks))
    return n
