"""Compact parameter deltas: the `[K, n_shards, n_sel, block]` representation
of the compact-gradient train step, shared by both halves of serving.

- **train half**: an online train wave materializes `base + delta` for the
  trainable suffix (a copy: `apply_delta_tree`), runs the compact train
  step on it, and re-extracts the delta (`extract_delta_tree`). The base
  weights are never written.
- **serve half**: decode applies the same delta as a gather-add at matmul
  time (`repro_torch.models.common.delta_matmul_add`), so no dense
  per-user weight copy ever exists.

Values are fp32 throughout: a delta is the exact difference of two
param-dtype (bf16) tensors, which fp32 holds exactly, so
`scatter(gather(base) + delta)` rebuilds the trained weights bitwise.

Shapes, per selectable leaf of a trainable segment stack `[K, *lead, N]`:

    idx   [K, n_shards, n_sel]                   int32 block ids per shard
    vals  [K, *lead, n_shards, n_sel, block]     fp32 selected-block delta
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.sparse_update import (SelSpec, gather_param_blocks,
                                            scatter_param_blocks,
                                            tree_leaves)

__all__ = [
    "DeltaState", "DECODE_DELTA_PARENTS", "apply_delta_tree",
    "decode_delta_spec", "extract_delta_tree", "zeros_delta_tree",
]

# sublayer dicts whose selectable matmuls the serve-time gather-add covers:
# plain [B,S,d] x [d,N] projections of attention and dense MLP blocks.
# Mixer-internal matmuls and expert-batched MoE weights take no delta on
# the decode path.
DECODE_DELTA_PARENTS = {
    "attn": ("wq", "wk", "wv", "wo"),
    "mlp": ("w_gate", "w_up", "w_down"),
}


@dataclasses.dataclass
class DeltaState:
    """One user's compact parameter delta against a fixed base model.

    `idx` / `vals` are per-segment trees mirroring the (pruned) selection
    spec; the serve engine keeps its store's entries on the host (CPU
    tensors) and copies them onto the card when a request is admitted."""
    idx: dict           # seg -> nested {leaf: [K, n_shards, n_sel] int32}
    vals: dict          # seg -> nested {leaf: [K, *lead, h, n_sel, block] f32}

    @property
    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size()
                   for a in tree_leaves(self.idx) + tree_leaves(self.vals))

    def to_tree(self) -> dict:
        """Checkpoint tree (plain nested dicts)."""
        return {"idx": self.idx, "vals": self.vals}

    @classmethod
    def from_tree(cls, tree: dict) -> "DeltaState":
        return cls(idx=tree["idx"], vals=tree["vals"])


def decode_delta_spec(plan, trainable_segments) -> dict:
    """Prune `plan.spec` to the leaves the decode gather-add can apply:
    2D-per-layer projections under an `attn`/`mlp` sublayer (see
    DECODE_DELTA_PARENTS). Returns {seg: nested {leaf: SelSpec}} with empty
    segments dropped."""
    def walk(spec, stack, parent):
        out = {}
        for name, sub in spec.items():
            if isinstance(sub, dict):
                child = walk(sub, stack[name], name)
                if child:
                    out[name] = child
            elif (name in DECODE_DELTA_PARENTS.get(parent, ())
                  and stack[name].dim() == 3):
                out[name] = sub
        return out

    out = {}
    for seg, spec in plan.spec.items():
        if not plan.seg_trainable.get(seg) or seg not in trainable_segments:
            continue
        pruned = walk(spec, trainable_segments[seg], "")
        if pruned:
            out[seg] = pruned
    return out


def zeros_delta_tree(trainable_segments, idx_tree, spec_tree,
                     device="cpu") -> dict:
    """Zero-valued delta `vals` tree matching `spec_tree` (the shape
    `gather_param_blocks` would produce), on `device`."""
    def walk(stack, idx, spec):
        if isinstance(spec, SelSpec):
            k = idx.shape[0]
            lead = tuple(stack.shape[1:-1])
            return torch.zeros((k,) + lead + (spec.n_shards, spec.n_sel,
                                              spec.block),
                               dtype=torch.float32, device=device)
        return {name: walk(stack[name], idx[name], spec[name])
                for name in spec}

    return {seg: walk(trainable_segments[seg], idx_tree[seg], spec)
            for seg, spec in spec_tree.items()}


def apply_delta_tree(trainable_segments, vals_tree, idx_tree, spec_tree):
    """Materialize `base + delta` for the trainable segments: each selected
    block becomes `gather(base) + vals` (fp32 add, cast back to the param
    dtype), written into a copy of the leaf by `scatter_param_blocks` (one
    `block_scatter_update` launch per covered leaf on the card).
    Non-selectable leaves and unselected blocks pass through; the base
    tree itself is never written."""
    def walk(stack, vals, idx, spec):
        if isinstance(spec, SelSpec):
            base = gather_param_blocks(stack, idx, spec).float()
            return scatter_param_blocks(stack, base + vals, idx, spec)
        return {name: (walk(sub, vals[name], idx[name], spec[name])
                       if name in spec else sub)
                for name, sub in stack.items()}

    out = {}
    for seg, stack in trainable_segments.items():
        spec = spec_tree.get(seg)
        if not spec or idx_tree.get(seg) is None or \
                vals_tree.get(seg) is None:
            out[seg] = stack
        else:
            out[seg] = walk(stack, vals_tree[seg], idx_tree[seg], spec)
    return out


def extract_delta_tree(base_segments, new_segments, idx_tree, spec_tree):
    """Inverse of `apply_delta_tree` after training: the compact fp32
    difference `gather(new) - gather(base)` per selectable leaf."""
    def walk(base, new, idx, spec):
        if isinstance(spec, SelSpec):
            return (gather_param_blocks(new, idx, spec).float()
                    - gather_param_blocks(base, idx, spec).float())
        return {name: walk(base[name], new[name], idx[name], spec[name])
                for name in spec}

    return {seg: walk(base_segments[seg], new_segments[seg],
                      idx_tree[seg], spec)
            for seg, spec in spec_tree.items()}
