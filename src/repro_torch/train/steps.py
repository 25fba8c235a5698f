"""Train-state and train-step builders (dense baseline + DGSU sparse).

The state is a plain dict with the reference package's keys:

    {"step", "params_trainable", "params_frozen", "opt", "sel_idx", "rng"}

`step` is a host int (the schedule's phase is decided on the host, so a
step never waits for the device to learn it) and `rng` the int seed every
dynamic-phase draw derives from. The rest are tensors on the device.

Storage: the state's params are views of the tree it was built from, and
the compact step updates the selected blocks of the trainable weights and
their optimizer state in place (one fused kernel launch per leaf), like the
reference's donated state. Build a fresh state, or clone one, to run two
steps from the same start.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import (ShapeConfig, SparseUpdateConfig,
                                      TrainConfig)
from repro_torch.core.schedule import maybe_reselect
from repro_torch.core.selection import (SelectionPlan, build_plan,
                                        magnitude_selection, random_selection)
from repro_torch.core.sparse_update import (gather_selected_tree,
                                            map_selectable, merge_stack,
                                            split_stack, tree_leaves,
                                            tree_map)
from repro_torch.models import transformer as T
from repro_torch.optim import apply_updates, apply_updates_mixed, init_opt_state

TrainState = dict


def split_params(params, plan: SelectionPlan):
    """Split full params into (frozen, trainable) trees per the plan."""
    frozen: dict = {"segments": {}}
    trainable: dict = {"segments": {}}
    for key in params:
        if key == "segments":
            continue
        if plan.update_embeddings and key in ("embed", "lm_head"):
            trainable[key] = params[key]
        else:
            frozen[key] = params[key]
    for seg_name, stack in params["segments"].items():
        f, t = split_stack(stack, plan.seg_trainable.get(seg_name, 0))
        if f is not None:
            frozen["segments"][seg_name] = f
        if t is not None:
            trainable["segments"][seg_name] = t
    return frozen, trainable


def merge_params(frozen, trainable):
    """Inverse of split_params (for export / eval)."""
    out = {}
    for tree in (frozen, trainable):
        for key, val in (tree or {}).items():
            if key != "segments":
                out[key] = val
    f_segs = (frozen or {}).get("segments", {})
    t_segs = (trainable or {}).get("segments", {})
    out["segments"] = {name: merge_stack(f_segs.get(name), t_segs.get(name))
                       for name in list(f_segs) + [n for n in t_segs
                                                   if n not in f_segs]}
    return out


def make_train_state(tc: TrainConfig, params=None,
                     selection_init: str = "magnitude",
                     device="cuda") -> tuple[TrainState, SelectionPlan]:
    """Initial state and selection plan. params: a param tree on `device`
    (random from tc.seed when None)."""
    cfg = tc.model
    if params is None:
        params = T.init_params(cfg, tc.seed, device)
    if tc.sparse.enabled:
        tokens_per_device = tc.shape.global_batch * tc.shape.seq_len
        plan = build_plan(cfg, tc.sparse, tokens_per_device)
        if selection_init == "magnitude":
            sel_idx = magnitude_selection(plan, params)
        else:
            sel_idx = random_selection(plan, tc.seed, 0, device)
    else:
        plan = build_plan(cfg, SparseUpdateConfig(
            enabled=False, update_ratio=1.0, num_update_layers=10**9,
            channel_block=tc.sparse.channel_block))
        sel_idx = None
    frozen, trainable = split_params(params, plan)
    state = {
        "step": 0,
        "params_trainable": trainable,
        "params_frozen": frozen,
        "opt": init_opt_state(tc.optimizer, trainable),
        "sel_idx": sel_idx,
        "rng": tc.seed,
    }
    return state, plan


def _grads(loss, trees):
    """Gradients of `loss` w.r.t. every leaf of `trees` that requires grad,
    as same-structure trees with None elsewhere."""
    wrt = [leaf for tree in trees for leaf in tree_leaves(tree)
           if leaf.requires_grad]
    got = torch.autograd.grad(loss, wrt, allow_unused=True)
    it = iter(zip(wrt, got))

    def pick(leaf):
        if leaf is None or not leaf.requires_grad:
            return None
        src, g = next(it)
        return torch.zeros_like(src) if g is None else g
    return [tree_map(pick, tree) for tree in trees]


def make_train_step(tc: TrainConfig, plan: SelectionPlan,
                    use_selection: bool = True,
                    compact_grads: Optional[bool] = None):
    """Returns train_step(state, batch) -> (state, metrics).

    batch: {"tokens", "labels"} tensors on the state's device.
    compact_grads (default: tc.compact_grads) routes every segment weight
    with a SelSpec through the compact-gradient path: the backward emits the
    [K, n_shards, n_sel, block] dW directly (`block_sparse_dw`, one launch
    per weight and trainable layer; `batched_dw`, one per expert leaf and
    trainable layer) and `fused_block_opt` updates the selected weight and
    optimizer-state blocks in place (one launch per leaf). Non-selectable
    leaves (norms, the MoE router) take the dense rule. Otherwise the step
    is the dense-scatter one (with a selection) or the dense one."""
    cfg = tc.model
    remat = tc.remat != "none"
    if compact_grads is None:
        compact_grads = tc.compact_grads

    def train_step(state, batch):
        step = state["step"]
        trainable = state["params_trainable"]
        frozen = state["params_frozen"]
        device = tree_leaves(trainable)[0].device
        sel_idx = state["sel_idx"]
        if use_selection and tc.sparse.enabled and sel_idx is not None:
            sel_idx = maybe_reselect(plan, tc.sparse, sel_idx, step,
                                     state["rng"], device)
            sel = (sel_idx, plan.spec)
        else:
            sel = None

        # fresh leaves to differentiate; the state's tensors stay plain
        t_tree = tree_map(lambda a: a.detach().requires_grad_(True),
                          trainable)
        if compact_grads and sel is not None:
            # selectable weights only feed the forward matmul; their
            # gradient arrives compactly via `wsel`
            t_tree = map_selectable(t_tree, {"segments": plan.spec},
                                    lambda a: a.detach())
            wsel = gather_selected_tree(trainable.get("segments", {}),
                                        sel_idx, plan.spec)
            wsel = tree_map(lambda a: None if a is None
                            else a.requires_grad_(True), wsel)
            loss, metrics = T.loss_fn(cfg, (frozen, t_tree), batch,
                                      sel=(sel_idx, plan.spec, wsel),
                                      remat=remat)
            g_dense, g_sel = _grads(loss, [t_tree, wsel])
            new_params, new_opt = apply_updates_mixed(
                tc.optimizer, trainable, g_dense, g_sel, state["opt"], step,
                sel_idx, plan.spec)
        else:
            loss, metrics = T.loss_fn(cfg, (frozen, t_tree), batch, sel=sel,
                                      remat=remat)
            (grads,) = _grads(loss, [t_tree])
            new_params, new_opt = apply_updates(tc.optimizer, trainable,
                                                grads, state["opt"], step)
        new_state = {
            "step": step + 1,
            "params_trainable": new_params,
            "params_frozen": frozen,
            "opt": new_opt,
            "sel_idx": sel_idx,
            "rng": state["rng"],
        }
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        return new_state, metrics

    return train_step


def make_online_wave(cfg, sparse, optimizer, plan: SelectionPlan, *,
                     wave_tokens: int):
    """Builds the serve engine's online personalization train wave.

    Returns `wave(trainable_base, frozen, delta_vals, sel_idx, batch) ->
    (new_delta_vals, metrics)`, which advances one user's compact delta
    (`repro_torch.core.delta`) by one compact train step without writing the
    shared base params:

      1. materialize `base + delta` for the trainable suffix into a copy of
         its covered leaves (one `block_scatter_update` launch per leaf on
         the card),
      2. run the compact train step on it (one `block_sparse_dw` launch per
         leaf and trainable layer, one `fused_block_opt` per leaf), with
         the step index pinned to 0 so the three-phase schedule never
         reselects (requires `sparse.phase_fixed_early >= 1`),
      3. re-extract `gather(new) - gather(base)` as the updated delta.

    The reported loss is taken BEFORE the update. Restricted to sgd with
    momentum 0: a user's state is the delta and nothing else."""
    from repro_torch.core.delta import apply_delta_tree, extract_delta_tree

    assert optimizer.kind == "sgd" and optimizer.momentum == 0.0, (
        "online waves keep no per-user optimizer state: use sgd, momentum 0")
    assert sparse.phase_fixed_early >= 1, (
        "wave pins step=0; phase_fixed_early=0 would reselect in-wave")
    tc = TrainConfig(model=cfg,
                     shape=ShapeConfig("wave", wave_tokens, 1, "train"),
                     sparse=sparse, optimizer=optimizer, compact_grads=True)
    step = make_train_step(tc, plan, use_selection=True, compact_grads=True)

    def wave(trainable_base, frozen, delta_vals, sel_idx, batch):
        base_segs = trainable_base.get("segments", {})
        pers = dict(trainable_base)
        pers["segments"] = apply_delta_tree(base_segs, delta_vals, sel_idx,
                                            plan.spec)
        state = {
            "step": 0,
            "params_trainable": pers,
            "params_frozen": frozen,
            "opt": init_opt_state(tc.optimizer, pers),
            "sel_idx": sel_idx,
            "rng": sparse.seed,
        }
        new_state, metrics = step(state, batch)
        new_vals = extract_delta_tree(
            base_segs, new_state["params_trainable"]["segments"], sel_idx,
            plan.spec)
        return new_vals, metrics

    return wave
