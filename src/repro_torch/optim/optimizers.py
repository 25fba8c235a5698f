"""Optimizers: SGD (the paper's default, momentum 0 and no state), SGD with
momentum, and AdamW, with linear warmup and cosine decay.

Two update entry points share one per-leaf rule:

- `apply_updates`: the dense sweep. Gradients arrive full-shape (zeros
  outside the selection) and every element is updated. Pure: returns new
  tensors.
- `apply_updates_mixed`: the compact-gradient path. Selectable leaves arrive
  as compact [K, *lead, n_shards, n_sel, block] gradients and are updated by
  one `fused_block_opt` launch each, in place: deselected blocks, and their
  optimizer state, are never touched. Other leaves take the dense rule.

The arithmetic follows the reference package's `optim/optimizers.py` op
for op in fp32, with Python floats entering as fp32 (JAX's weak types).

On a mesh a rank updates its own shards; only the global-norm clip needs
the others: `sharded` = (a tree of bools, True where the leaf is a slice
of its weight, and the model group) makes the norm the whole model's:
sharded leaves' squares are summed over the model group, replicated ones
counted once (the data group has already summed the gradients).
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import OptimizerConfig
from repro_torch import sharding as SH
from repro_torch.core.sparse_update import SelSpec, tree_leaves, tree_map
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import block_rule


def learning_rate(oc: OptimizerConfig, step) -> torch.Tensor:
    """Linear warmup then cosine decay (paper §IV-A), as a 0-dim fp32
    tensor computed in fp32."""
    step = torch.as_tensor(step, dtype=torch.float32)
    lr = torch.tensor(oc.learning_rate, dtype=torch.float32)
    if oc.warmup_steps > 0:
        warm = torch.minimum(torch.tensor(1.0),
                             (step + 1.0) / oc.warmup_steps)
    else:
        warm = 1.0
    if oc.decay_steps > 0:
        t = torch.clip((step - oc.warmup_steps) /
                       max(1, oc.decay_steps - oc.warmup_steps), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    else:
        cos = 1.0
    return lr * warm * cos


def _hyper(oc: OptimizerConfig, step, device) -> torch.Tensor:
    """fp32 [lr, t] on `device` (t = step + 1, AdamW's bias-correction
    step), read by the fused kernel from device memory."""
    lr = learning_rate(oc, step)
    t = torch.as_tensor(step, dtype=torch.float32) + 1.0
    return torch.stack([lr, t]).to(device)


def _split_squares(g, flags, acc: list) -> None:
    """acc[0] += squares of the sharded leaves, acc[1] of the others."""
    if isinstance(g, dict):
        for k, v in g.items():
            if v is not None:
                _split_squares(v, flags[k], acc)
    elif g is not None:
        i = 0 if flags else 1
        acc[i] = acc[i] + torch.sum(torch.square(g.float()))


def clip_by_global_norm(grads, max_norm: float, sharded=None):
    """Scale `grads` so their global L2 norm is at most `max_norm` (no-op
    for max_norm <= 0). sharded: (flags tree, model group) on a mesh."""
    if max_norm <= 0:
        return grads, torch.zeros(())
    if sharded is None:
        sq = sum(torch.sum(torch.square(g.float()))
                 for g in tree_leaves(grads))
    else:
        flags, group = sharded
        dev = tree_leaves(grads)[0].device
        acc = [torch.zeros((), device=dev), torch.zeros((), device=dev)]
        _split_squares(grads, flags, acc)
        sq = SH.all_reduce_(acc[0], group, "aux") + acc[1]
    norm = torch.sqrt(sq)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: None if g is None else (g * scale).to(g.dtype),
                    grads), norm


def init_opt_state(oc: OptimizerConfig, trainable) -> dict:
    if oc.kind == "sgd" and oc.momentum == 0.0:
        return {}                                # paper default: zero state
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    if oc.kind in ("sgd", "momentum"):
        return {"mu": tree_map(zeros, trainable)}
    if oc.kind == "adamw":
        return {"mu": tree_map(zeros, trainable),
                "nu": tree_map(zeros, trainable)}
    raise ValueError(oc.kind)


def _kind(oc: OptimizerConfig) -> str:
    if oc.kind == "sgd" and oc.momentum == 0.0:
        return "sgd"
    if oc.kind in ("sgd", "momentum"):
        return "momentum"
    if oc.kind == "adamw":
        return "adamw"
    raise ValueError(oc.kind)


def _leaf_update(oc: OptimizerConfig, lr, t, p, g, mu, nu):
    """(new_param, new_mu, new_nu), None for absent state; fp32 compute,
    cast back to the param dtype."""
    new, mu_new, nu_new = block_rule(
        _kind(oc), lr, t, p.float(), g.float(), mu, nu,
        momentum=oc.momentum, beta1=oc.beta1, beta2=oc.beta2, eps=oc.eps,
        weight_decay=oc.weight_decay)
    return new.to(p.dtype), mu_new, nu_new


def _first_leaf(tree):
    return tree_leaves(tree)[0]


def _pick(res, i):
    if isinstance(res, dict):
        return {k: _pick(v, i) for k, v in res.items()}
    return res[i]


def apply_updates(oc: OptimizerConfig, params, grads, state: dict, step,
                  sharded=None):
    """Dense sweep: returns (new_params, new_state). sharded: see the
    module doc (the mesh-wide clip)."""
    hyper = _hyper(oc, step, _first_leaf(params).device)
    lr, t = hyper[0], hyper[1]
    grads, _ = clip_by_global_norm(grads, oc.grad_clip, sharded)

    def walk(p, g, mu, nu):
        if isinstance(p, dict):
            return {k: walk(p[k], g[k], mu[k] if mu is not None else None,
                            nu[k] if nu is not None else None) for k in p}
        return _leaf_update(oc, lr, t, p, g, mu, nu)

    res = walk(params, grads, state.get("mu"), state.get("nu"))
    new_state = {}
    if "mu" in state:
        new_state["mu"] = _pick(res, 1)
    if "nu" in state:
        new_state["nu"] = _pick(res, 2)
    return _pick(res, 0), new_state


def apply_updates_mixed(oc: OptimizerConfig, params, grads, compact_grads,
                        state: dict, step, sel_idx, spec_tree, sharded=None):
    """Compact-gradient update. Selectable leaves (those with a SelSpec in
    `spec_tree`, keyed by segment under params["segments"]) are updated in
    place on their selected blocks by one fused kernel launch each; their
    optimizer state outside the selection is untouched (frozen). All other
    leaves take the dense rule with their `grads` leaf.

    grads: the dense gradients of the non-selectable leaves (None at the
    selectable ones). compact_grads: {segment: nested {leaf: compact dW}}
    matching `sel_idx` / `spec_tree`. Returns (new_params, new_state); the
    selectable leaves are the input tensors, updated in place. sharded:
    see the module doc (a compact leaf is sharded where its weight is)."""
    hyper = _hyper(oc, step, _first_leaf(params).device)
    lr, t = hyper[0], hyper[1]
    if oc.grad_clip > 0:
        # joint clip: compact leaves hold exactly the nonzero content of
        # their dense counterparts, so the norm is the dense sweep's up to
        # float-accumulation order
        if sharded is not None:
            flags, group = sharded
            sharded = ({"d": flags, "c": flags["segments"]}, group)
        clipped, _ = clip_by_global_norm({"d": grads, "c": compact_grads},
                                         oc.grad_clip, sharded)
        grads, compact_grads = clipped["d"], clipped["c"]

    def walk(p, g, cg, spec, idx, mu, nu):
        if isinstance(spec, SelSpec):
            return kops.fused_block_optimizer(oc, p, cg, idx, spec, mu, nu,
                                              hyper)
        if isinstance(p, dict):
            out = {}
            for key, sub in p.items():
                in_spec = isinstance(spec, dict) and key in spec
                out[key] = walk(
                    sub, g[key] if g is not None else None,
                    cg[key] if in_spec and cg is not None else None,
                    spec[key] if in_spec else None,
                    idx[key] if in_spec and idx is not None else None,
                    mu[key] if mu is not None else None,
                    nu[key] if nu is not None else None)
            return out
        return _leaf_update(oc, lr, t, p, g, mu, nu)

    res = walk(params, grads, {"segments": compact_grads or {}},
               {"segments": spec_tree}, {"segments": sel_idx or {}},
               state.get("mu"), state.get("nu"))
    new_state = {}
    if "mu" in state:
        new_state["mu"] = _pick(res, 1)
    if "nu" in state:
        new_state["nu"] = _pick(res, 2)
    return _pick(res, 0), new_state
