"""Dynamic gradient sparse update, as PyTorch autograd machinery.

Two mechanisms (paper §III-B):

1. **Layer selection**: only the last-K blocks of the layer stack are
   trainable. `split_stack` cuts the stacked layer params [L, ...] into a
   frozen prefix and a trainable suffix; the model runs the prefix under
   `torch.no_grad()`, so no activation of it is kept for backward — the
   paper's "discard the corresponding output features" memory saving.

2. **Channel selection**: within trainable layers, each weight's output
   channel blocks are selected with ratio r. `smm` (sparse matmul) is a
   drop-in `x @ w` whose backward computes dW only for the selected blocks
   (`compact_dw`, the `block_sparse_dw` kernel on the card). dX is always
   dense.

Selection indices are data (int32 tensors [n_shards, n_sel] per weight,
local to each output shard), so the dynamic phase of Algorithm 1 draws new
ones every step without rebuilding anything.

Two backward forms, as in the reference package:

- dense-scatter (`_SMM`): the compact dW is scattered into a zero [K, N]
  buffer, the weight's full-shape gradient, and the optimizer sweeps it.
- compact (`_SMMCompact`): the train step gathers the selected blocks of
  each selectable weight into `w_sel` [K, n_shards, n_sel, block] and
  differentiates with respect to it; the full weight enters the forward
  detached. The backward hands the compact dW to `w_sel` directly, and
  `optim.apply_updates_mixed` updates the selected blocks in place.

The equivalence guarantees between the two are the reference's: SGD
(momentum 0, no weight decay) bitwise; momentum / AdamW identical under a
fixed selection; under dynamic reselection the compact path freezes the
state of deselected blocks.

Stacked expert weights [E, K, N] (the MoE layer's routed experts, one
selection shared by every expert) take the batched forms, `_SMMBatched` and
`_SMMBatchedCompact`, whose dW is one `batched_dw` launch for all experts.
`compress_grads` and the compact all-reduce come with the multi-GPU slice.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref


class SelSpec(NamedTuple):
    """Static description of one weight's channel selection."""
    block: int        # channels per block
    n_shards: int     # TP shards of the out dim
    n_sel: int        # selected blocks per shard
    n_blocks: int     # total blocks per shard


# ---------------------------------------------------------------------------
# sparse matmul
# ---------------------------------------------------------------------------

def _scatter_blocks(dw_sel, idx, spec: SelSpec, dtype):
    """dw_sel: [*lead, n_shards, n_sel, block] -> full [*lead, N] with zeros
    outside the selected blocks."""
    lead = dw_sel.shape[:-3]
    n = spec.n_shards * spec.n_blocks * spec.block
    zeros = torch.zeros((1, math.prod(lead), n), dtype=dtype,
                        device=dw_sel.device)
    full = kref.scatter_blocks3(
        zeros, dw_sel.reshape((1, -1) + tuple(dw_sel.shape[-3:])),
        idx[None], spec.block)
    return full.reshape(lead + (n,))


def compact_dw(x2, dy2, idx, spec: SelSpec):
    """The paper's compute skip: dW for selected blocks only.

    x2: [M, K], dy2: [M, N] (contiguous) -> [K, n_shards, n_sel, block]
    fp32. One `block_sparse_dw` launch on the card; its plain version on
    the CPU."""
    if not x2.is_cuda and spec.n_sel == spec.n_blocks:
        # full selection: the gather is a pure permutation, so the einsum
        # reads a reshaped VIEW of dy2 and the (M-times smaller) output is
        # reordered instead of a gathered copy of the activations
        dyb = dy2.reshape(dy2.shape[0], spec.n_shards, spec.n_blocks,
                          spec.block)
        dw_all = torch.einsum("mk,msnb->ksnb", x2.float(), dyb.float())
        index = idx.long()[None, :, :, None].expand(
            x2.shape[1], spec.n_shards, spec.n_sel, spec.block)
        return torch.gather(dw_all, 2, index)
    return kops.block_sparse_dw(x2, dy2, idx, spec)


def _dx_and_dw_sel(x, w, idx, spec: SelSpec, dy):
    k, n = w.shape
    dx = torch.matmul(dy, w.t()).to(x.dtype)
    # the saved x and the incoming dy may be non-contiguous views; the
    # kernel takes contiguous rows
    dw_sel = compact_dw(x.reshape(-1, k).contiguous(),
                        dy.reshape(-1, n).contiguous(), idx, spec)
    return dx, dw_sel


class _SMM(torch.autograd.Function):
    """`x @ w` whose weight gradient is the compact dW scattered into a
    zero buffer (the dense-scatter path)."""

    @staticmethod
    def forward(ctx, x, w, idx, spec):
        ctx.save_for_backward(x, w, idx)
        ctx.spec = spec
        return torch.matmul(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w, idx = ctx.saved_tensors
        dx, dw_sel = _dx_and_dw_sel(x, w, idx, ctx.spec, dy)
        dw = _scatter_blocks(dw_sel, idx, ctx.spec, w.dtype)
        return dx, dw, None, None


class _SMMCompact(torch.autograd.Function):
    """Same forward; the weight gradient comes out as the compact
    [K, n_shards, n_sel, block] gradient of `w_sel` (the gathered selected
    blocks, unused in the forward). `w` must arrive detached."""

    @staticmethod
    def forward(ctx, x, w, w_sel, idx, spec):
        ctx.save_for_backward(x, w, idx)
        ctx.spec = spec
        return torch.matmul(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w, idx = ctx.saved_tensors
        dx, dw_sel = _dx_and_dw_sel(x, w, idx, ctx.spec, dy)
        # cast to the weight's dtype, as the reference does: the optimizer
        # sees the same rounded gradient on both paths
        return dx, None, dw_sel.to(w.dtype), None, None


def smm(x, w, sel, name: str):
    """Sparse matmul: `x @ w` with channel-block-sparse dW.

    sel: None (dense backward), a pair (idx_dict, spec_dict), or a triple
    (idx_dict, spec_dict, wsel_dict). idx_dict[name] is int32
    [n_shards, n_sel], spec_dict[name] a SelSpec. With a triple, the
    backward is compact: the gradient flows to wsel_dict[name] instead of
    a full-shape dW. Weights absent from the dicts take the dense backward.
    """
    if sel is None:
        return torch.matmul(x, w)
    idx_dict, spec_dict = sel[0], sel[1]
    if idx_dict is None or name not in idx_dict:
        return torch.matmul(x, w)
    idx, spec = idx_dict[name], spec_dict[name]
    wsel_dict = sel[2] if len(sel) > 2 else None
    if wsel_dict is not None and name in wsel_dict:
        fn = _SMMCompact if w.dim() == 2 else _SMMBatchedCompact
        return fn.apply(x, w.detach(), wsel_dict[name], idx, spec)
    if w.dim() == 2:
        return _SMM.apply(x, w, idx, spec)
    return _SMMBatched.apply(x, w, idx, spec)


# batched (expert) forms: x [E, C, K], w [E, K, N], one selection for all E.
# The products outside the dW kernel are plain batched matmuls, as the
# reference leaves its einsums to XLA.

def compact_dw_batched(x3, dy3, idx, spec: SelSpec):
    """Expert-batched compute skip: per-expert dW for selected blocks only.

    x3: [E, C, K], dy3: [E, C, N] (contiguous) -> [E, K, n_shards, n_sel,
    block] fp32. One `batched_dw` launch for all experts on the card; its
    plain version on the CPU."""
    return kops.block_sparse_dw_batched(x3, dy3, idx, spec)


def _dx_and_dw_sel_batched(x, w, idx, spec: SelSpec, dy):
    dx = torch.bmm(dy, w.transpose(1, 2)).to(x.dtype)
    dw_sel = compact_dw_batched(x.contiguous(), dy.contiguous(), idx, spec)
    return dx, dw_sel


class _SMMBatched(torch.autograd.Function):
    """Per-expert `x @ w` whose weight gradient is the compact dW scattered
    into a zero [E, K, N] buffer (the dense-scatter path)."""

    @staticmethod
    def forward(ctx, x, w, idx, spec):
        ctx.save_for_backward(x, w, idx)
        ctx.spec = spec
        return torch.bmm(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w, idx = ctx.saved_tensors
        dx, dw_sel = _dx_and_dw_sel_batched(x, w, idx, ctx.spec, dy)
        return dx, _scatter_blocks(dw_sel, idx, ctx.spec, w.dtype), None, None


class _SMMBatchedCompact(torch.autograd.Function):
    """Same forward; the gradient goes to `w_sel` [E, K, n_shards, n_sel,
    block] and `w` (which must arrive detached) gets none."""

    @staticmethod
    def forward(ctx, x, w, w_sel, idx, spec):
        ctx.save_for_backward(x, w, idx)
        ctx.spec = spec
        return torch.bmm(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w, idx = ctx.saved_tensors
        dx, dw_sel = _dx_and_dw_sel_batched(x, w, idx, ctx.spec, dy)
        return dx, None, dw_sel.to(w.dtype), None, None


# ---------------------------------------------------------------------------
# compact-path block gather/scatter (params and optimizer state)
# ---------------------------------------------------------------------------

def gather_param_blocks(w, idx, spec: SelSpec):
    """Stacked leaf [K, *lead, N] -> compact [K, *lead, n_shards, n_sel,
    block] of the selected blocks. idx: [K, n_shards, n_sel]. Lead dims
    flatten into rows: the selection is per column block."""
    k, n = w.shape[0], w.shape[-1]
    out = kref.gather_blocks3(w.reshape(k, -1, n), idx, spec.block)
    return out.reshape(w.shape[:-1] + out.shape[-3:])


def scatter_param_blocks(w, vals, idx, spec: SelSpec):
    """Inverse of gather_param_blocks, out of place: a copy of `w` with its
    selected blocks overwritten by `vals` (cast to w's dtype; unselected
    blocks untouched, `w` itself never written). The overwrite is one
    `block_scatter_update` launch on the card (the kernel writes in place,
    so it writes into the copy), its plain version on the CPU."""
    return kops.block_scatter_update(w.contiguous().clone(),
                                     vals.contiguous(), idx, spec)


def map_selectable(tree, spec_tree, fn):
    """Apply `fn` to every leaf of `tree` that has a SelSpec in `spec_tree`
    (matched by key); other leaves pass through unchanged."""
    def walk(node, spec):
        if isinstance(spec, SelSpec):
            return fn(node)
        if isinstance(node, dict):
            return {key: (walk(val, spec[key])
                          if isinstance(spec, dict) and key in spec else val)
                    for key, val in node.items()}
        return node
    return walk(tree, spec_tree)


def gather_selected_tree(segments, idx_tree, spec_tree):
    """Compact companion tree of the trainable segments: for each SelSpec
    leaf, its gathered selected blocks; segments without selection map to
    None. All three trees are keyed by segment name."""
    def walk(stack, idx, spec):
        if isinstance(spec, SelSpec):
            return gather_param_blocks(stack, idx, spec)
        return {key: walk(stack[key], idx[key], spec[key]) for key in spec}

    out = {}
    for seg, spec in spec_tree.items():
        if idx_tree.get(seg) is None or seg not in segments or not spec:
            out[seg] = None
            continue
        out[seg] = walk(segments[seg], idx_tree[seg], spec)
    return out


# ---------------------------------------------------------------------------
# layer-level split (frozen prefix / trainable suffix of the layer stack)
# ---------------------------------------------------------------------------

def tree_map(fn, *trees):
    """Map `fn` over the leaves of same-structure nested dicts."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [] if tree is None else [tree]


def split_stack(stack, n_trainable: int):
    """Split stacked layer params [L, ...] into (frozen [L-K], trainable
    [K]); views, no copies."""
    if n_trainable <= 0:
        return stack, None
    depth = tree_leaves(stack)[0].shape[0]
    if n_trainable >= depth:
        return None, stack
    frozen = tree_map(lambda a: a[: a.shape[0] - n_trainable], stack)
    trainable = tree_map(lambda a: a[a.shape[0] - n_trainable:], stack)
    return frozen, trainable


def merge_stack(frozen, trainable):
    if frozen is None:
        return trainable
    if trainable is None:
        return frozen
    return tree_map(lambda a, b: torch.cat([a, b], dim=0), frozen, trainable)
