"""Audits of a train step as it runs: the counterparts of the reference's
`launch/hlo_analysis.py` that are not about HLO text or meshes.

- `full_gradient_audit` / `weight_gradient_tensors` stand in for
  `zero_init_scatters` / `weight_gradient_scatters`: where the reference
  searches the lowered StableHLO for scatters into zero-filled blocked
  weight buffers, the port watches the step's aten ops (a
  `TorchDispatchMode`) and records every op output shaped as a full
  selectable weight. An empty record certifies that the step materialized
  no full-size weight gradient.
- `launch_breakdown` / `plan_launches` stand in for `kernel_launch_count`
  / `kernel_launch_breakdown`: the port has no static launch sites to
  count, so it counts launches (`kernels.ops.LAUNCHES`) around one call of
  a step, against the launches its plan derives: the reference's constant
  number of sites per selectable leaf becomes a constant number of
  launches per leaf and trainable step.

- `replicated_matmul_leaves` audits a sharded serve step: where the
  reference walks the jaxpr of its `shard_map` for dot_generals on a
  weight's full shape, the port watches the step's matrix products
  (`aten.mm` / `bmm` / `addmm` / `matmul`) and records every operand
  shaped as the full shape of a weight the sharding policy splits. An
  empty record certifies that every such product ran on the rank's shard.

Not ported: `parse_hlo`, `collective_bytes`, `while_trip_counts` and the
text form of `kernel_launch_count` read XLA's HLO text, which the port
does not have.
"""
from __future__ import annotations

import weakref
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core.sparse_update import SelSpec
from repro_torch.kernels import ops

_VIEW_OR_META = {"aten::empty", "aten::empty_strided", "aten::empty_like",
                 "aten::detach", "aten::lift_fresh"}


def selectable_weights(plan, params) -> dict:
    """{leaf path: (stacked weight, SelSpec)} of every selectable leaf of a
    segment with trainable steps: `params` is a param tree (or a train
    state's `params_trainable`) holding the stacked leaves."""
    out = {}

    def walk(spec, node, path):
        if isinstance(spec, SelSpec):
            out[path] = (node, spec)
            return
        for name, sub in spec.items():
            if node is not None and name in node:
                walk(sub, node[name], f"{path}/{name}")

    for seg, steps in plan.seg_trainable.items():
        if steps:
            walk(plan.spec[seg], params["segments"].get(seg),
                 f"segments/{seg}")
    return out


def _signatures(weights: dict) -> dict:
    """shape -> names of the leaves that shape belongs to: the stacked
    leaf, one step of it (an expert leaf keeps its expert axis), and the
    blocked layouts [..., n_shards, n_blocks, block] of both."""
    sigs: dict = {}
    for name, (w, sp) in weights.items():
        stacked = tuple(w.shape)
        blocked = stacked[:-1] + (sp.n_shards, sp.n_blocks, sp.block)
        for shape in (stacked, stacked[1:], blocked, blocked[1:]):
            sigs.setdefault(shape, set()).add(name)
    return sigs


def _squeeze_front(shape: tuple) -> tuple:
    while len(shape) > 1 and shape[0] == 1:
        shape = shape[1:]
    return shape


def _storage(t) -> int:
    try:
        return t.untyped_storage().data_ptr()
    except (RuntimeError, NotImplementedError):
        return 0


class FullGradientAudit(TorchDispatchMode):
    """Records every aten op output shaped as a full selectable weight (a
    step of it, the stacked leaf, or their blocked layouts; leading size-1
    axes ignored) that is computed from no parameter. Products against a
    parameter are not gradients, though a dx `dy @ w.t()` has the weight's
    shape when the tokens equal its fan-in; so an op with an input that
    shares storage with a param, or with a same-size copy of one (a cast,
    a transposed copy: a one-input op whose output has its input's size),
    is skipped. Views and allocations are never recorded: only ops that
    compute values are. Each record is {"op", "shape", "dtype", "bytes",
    "backward" (the op ran inside an autograd node), "leaves" (the leaves
    of that shape)}.

    The test is by shape, so a tensor that merely shares a selectable
    weight's shape is recorded too, such as the dense gradient of a leaf
    outside the selection of the same shape: the audit can over-report,
    and an empty record still certifies.

    weights: `selectable_weights(plan, params)`; params: every param tensor
    of the step (the trainable and the frozen tree: the lm head's fp32
    copy feeds the CE's dx). The tensors must hold storage (CPU or CUDA):
    on `meta` every storage is the same null pointer."""

    def __init__(self, weights: dict, params=()):
        super().__init__()
        leaves = [w for w, _ in weights.values()] + list(params)
        if any(w.is_meta for w in leaves):
            raise ValueError("the full-gradient audit needs real tensors, "
                             "not meta ones")
        self.sigs = _signatures(weights)
        self.param_storage = {_storage(w) for w in leaves}
        self.copies: dict = {}         # storage -> weakref of a param copy
        self.records: list[dict] = []
        self.ops_seen = 0
        self.backward_ops = 0

    def _from_param(self, t) -> bool:
        ptr = _storage(t)
        if ptr in self.param_storage:
            return True
        ref = self.copies.get(ptr)
        return ref is not None and ref() is not None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops_seen += 1
        backward = torch._C._current_autograd_node() is not None
        self.backward_ops += backward
        outs = [t for t in (out if isinstance(out, (tuple, list)) else [out])
                if isinstance(t, torch.Tensor)]
        inputs = [a for a in list(args) + list(kwargs.values())
                  for a in (a if isinstance(a, (tuple, list)) else [a])
                  if isinstance(a, torch.Tensor)]
        from_param = [a for a in inputs if self._from_param(a)]
        if len(inputs) == 1 and from_param:
            for t in outs:
                if t.numel() == inputs[0].numel():
                    self.copies[_storage(t)] = weakref.ref(t)
        if (func._schema.name in _VIEW_OR_META or func.is_view
                or from_param):
            return out
        for t in outs:
            names = self.sigs.get(_squeeze_front(tuple(t.shape)))
            if names:
                self.records.append({
                    "op": str(func), "shape": tuple(t.shape),
                    "dtype": str(t.dtype).removeprefix("torch."),
                    "bytes": t.numel() * t.element_size(),
                    "backward": backward, "leaves": sorted(names)})
        return out


def full_gradient_audit(fn: Callable, weights: dict, params=()):
    """Runs `fn()` under a `FullGradientAudit(weights, params)`; returns
    (fn's result, the audit)."""
    audit = FullGradientAudit(weights, params)
    with audit:
        result = fn()
    return result, audit


def weight_gradient_tensors(audit: FullGradientAudit) -> list[dict]:
    """The audit's records made in the backward: the full-size tensors the
    step's gradient computation materialized for selectable weights. An
    empty list certifies the compact path (the reference's
    `weight_gradient_scatters(...) == []`)."""
    return [r for r in audit.records if r["backward"]]


def per_leaf_counts(records: list[dict], weights: dict) -> dict:
    """{leaf: records of its shape} for every leaf of `weights`; a leaf
    sharing its shape with others counts each record of that shape."""
    counts = {name: 0 for name in weights}
    for r in records:
        for name in r["leaves"]:
            counts[name] += 1
    return counts


def plan_launches(cfg, plan) -> dict:
    """Kernel launches a compact step makes, derived from its plan: the dW
    once per selectable leaf and trainable step (`batched_dw` for a stacked
    expert leaf [steps, E, fan_in, out], `block_sparse_dw` for the rest; a
    super-block's sub-layers are leaves of their own), and the fused
    optimizer once per selectable stacked leaf (norms, routers and the
    mamba leaves outside the selection take the plain dense rule)."""
    from repro_torch.models.registry import abstract_params
    want = {k: 0 for k in ops.LAUNCHES}
    shapes = abstract_params(cfg)["segments"]
    for name, (w, _) in selectable_weights(plan, {"segments": shapes}).items():
        seg = name.split("/")[1]
        want["batched_dw" if w.dim() == 4
             else "block_sparse_dw"] += plan.seg_trainable[seg]
        want["fused_block_opt"] += 1
    return want


def _spec_count(spec) -> int:
    if isinstance(spec, SelSpec):
        return 1
    return sum(_spec_count(sub) for sub in spec.values())


def plan_leaf_count(plan) -> int:
    """Selectable stacked leaves of the plan's trainable segments: the
    `fused_block_opt` launches of one compact step."""
    return sum(_spec_count(plan.spec[seg])
               for seg, steps in plan.seg_trainable.items() if steps)


def launch_breakdown(fn: Callable):
    """Runs `fn()` and returns (its result, {kernel: launches it made}):
    the deltas of `kernels.ops.LAUNCHES` around the call (only launches on
    the card count; on the CPU every wrapper runs its plain version)."""
    before = ops.launch_counts()
    result = fn()
    after = ops.launch_counts()
    return result, {k: after[k] - before[k] for k in after}


# ---------------------------------------------------------------------------
# replication audit of a sharded serve step
# ---------------------------------------------------------------------------

_PRODUCTS = {"aten::mm", "aten::bmm", "aten::addmm", "aten::matmul",
             "aten::baddbmm"}


class _ProductShapes(TorchDispatchMode):
    """Records the shapes of the tensor operands of every matrix product."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func._schema.name in _PRODUCTS:
            self.shapes += [tuple(a.shape) for a in args
                            if isinstance(a, torch.Tensor)]
        return func(*args, **(kwargs or {}))


def replicated_matmul_leaves(fn: Callable, forbidden_shapes) -> list:
    """Run `fn()` and return the operand shapes of its matrix products that
    equal a forbidden (full, unsharded) weight shape
    (`models.decoding.sharded_param_shapes`): empty means every product on
    a policy-sharded weight took the rank's shard."""
    forbidden = {tuple(s) for s in forbidden_shapes}
    with _ProductShapes() as mode:
        fn()
    return [s for s in mode.shapes if s in forbidden]
