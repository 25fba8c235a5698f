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

On a mesh (`sharding.use_rules` with a `launch.mesh` mesh around both
builders and every step) the state is one rank's: its shards of the params
and optimizer state (`init_params(..., rules=)` or `bridge.params_to_rank`)
and of the selection (`core.selection.local_selection`); the plan is the
one the reference builds under the same rules. A step maps the model axis,
runs the model on the rank's data shard of the batch, and all-reduces over
the data group: the compact dW (nothing full-size), the gradients of the
dense-rule leaves (norms, the router), and the loss and metrics; or, on
the dense-scatter step, the full-shape gradients (their selected blocks
only under `compact_allreduce`). The kernels then see the rank's local
widths and local SelSpec. Model-group sums happen inside the model
(`models.layers`, `models.moe`, the vocab-parallel CE).
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from repro_torch import sharding as SH
from repro_torch.configs.base import (ShapeConfig, SparseUpdateConfig,
                                      TrainConfig)
from repro_torch.core.schedule import maybe_reselect
from repro_torch.core.selection import (SelectionPlan, build_plan,
                                        local_selection, local_spec_tree,
                                        magnitude_selection, random_selection)
from repro_torch.core.sparse_update import (SelSpec,
                                            compact_allreduce_enabled,
                                            compress_grads, map_selectable,
                                            merge_stack,
                                            selected_grad_targets,
                                            split_stack, tree_leaves,
                                            tree_map)
from repro_torch.models.registry import abstract_params
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


@contextlib.contextmanager
def on_mesh():
    """Yields the current rules' process mesh with its model axis mapped,
    or None off a mesh."""
    mesh = SH.process_mesh()
    if mesh is None:
        yield None
        return
    with SH.mapped_model_axis(SH.current_rules().model_axis):
        yield mesh


def make_train_state(tc: TrainConfig, params=None,
                     selection_init: str = "magnitude",
                     device="cuda") -> tuple[TrainState, SelectionPlan]:
    """Initial state and selection plan. params: a param tree on `device`
    (random from tc.seed when None). On a mesh: the rank's state (params
    the rank's shards; drawn whole and sliced when None) and the global
    plan."""
    cfg = tc.model
    with on_mesh() as mesh:
        if params is None:
            params = T.init_params(cfg, tc.seed, device,
                                   rules=None if mesh is None
                                   else SH.current_rules())
        if tc.sparse.enabled:
            tokens_per_device = tc.shape.global_batch * tc.shape.seq_len
            plan = build_plan(cfg, tc.sparse, tokens_per_device)
            if selection_init == "magnitude":
                sel_idx = magnitude_selection(
                    plan, params, None if mesh is None else cfg)
            else:
                sel_idx = random_selection(plan, tc.seed, 0, device)
                if mesh is not None:
                    sel_idx = local_selection(plan, sel_idx,
                                              SH.model_index())
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


def _reduce_tree(tree, group, kind: str):
    """All-reduce (sum) every tensor of a nested dict in place."""
    for leaf in tree_leaves(tree):
        SH.all_reduce_(leaf, group, kind)
    return tree


def _map_split(tree, spec_top, on_sel, on_other):
    """on_sel on the leaves with a SelSpec in `spec_top`, on_other on the
    rest (None leaves stay None)."""
    def other(node):
        if isinstance(node, dict):
            return {k: other(v) for k, v in node.items()}
        return None if node is None else on_other(node)

    def walk(node, spec):
        if isinstance(spec, SelSpec):
            return on_sel(node)
        if isinstance(node, dict):
            return {k: (walk(v, spec[k]) if isinstance(spec, dict)
                        and k in spec else other(v))
                    for k, v in node.items()}
        return other(node)
    return walk(tree, spec_top)


def _shard_flags(cfg, plan, trainable):
    """True where a trainable leaf is a slice of its whole weight."""
    _, full = split_params(abstract_params(cfg), plan)
    return tree_map(lambda loc, whole: tuple(loc.shape) != tuple(whole.shape),
                    trainable, full)


def make_train_step(tc: TrainConfig, plan: SelectionPlan,
                    use_selection: bool = True,
                    compact_grads: Optional[bool] = None, on_grads=None):
    """Returns train_step(state, batch) -> (state, metrics).

    batch: {"tokens", "labels"} tensors on the state's device (on a mesh:
    the rank's data shard of the global batch, `launch.specs`).
    on_grads(dense, compact), when given, sees the step's gradients after
    every reduction, before the update (compact is None on the
    dense-scatter and dense steps).
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
    cache: dict = {}

    def train_step(state, batch):
        with on_mesh() as mesh:
            return _step(state, batch, mesh)

    def _step(state, batch, mesh):
        step = state["step"]
        trainable = state["params_trainable"]
        frozen = state["params_frozen"]
        device = tree_leaves(trainable)[0].device
        sel_idx = state["sel_idx"]
        spec = plan.spec
        if mesh is not None:
            if "spec" not in cache:
                cache["spec"] = local_spec_tree(plan.spec)
                if tc.optimizer.grad_clip > 0:
                    cache["flags"] = _shard_flags(cfg, plan, trainable)
            spec = cache["spec"]
        if use_selection and tc.sparse.enabled and sel_idx is not None:
            new = maybe_reselect(plan, tc.sparse, sel_idx, step,
                                 state["rng"], device)
            if mesh is not None and new is not sel_idx:
                new = local_selection(plan, new, SH.model_index())
            sel_idx = new
            sel = (sel_idx, spec)
        else:
            sel = None
        data = SH.data_group()
        sharded = None if mesh is None or tc.optimizer.grad_clip <= 0 \
            else (cache["flags"], SH.model_group())

        # fresh leaves to differentiate; the state's tensors stay plain
        t_tree = tree_map(lambda a: a.detach().requires_grad_(True),
                          trainable)
        if compact_grads and sel is not None:
            # selectable weights only feed the forward matmul; their
            # gradient arrives compactly via `wsel`
            t_tree = map_selectable(t_tree, {"segments": spec},
                                    lambda a: a.detach())
            wsel = selected_grad_targets(trainable.get("segments", {}),
                                         sel_idx, spec)
            loss, metrics = T.loss_fn(cfg, (frozen, t_tree), batch,
                                      sel=(sel_idx, spec, wsel),
                                      remat=remat)
            g_dense, g_sel = _grads(loss, [t_tree, wsel])
            # the compact dW as it is: nothing full-size is reduced
            _reduce_tree(g_sel, data, "dw")
            _reduce_tree(g_dense, data, "grad_dense")
            if on_grads is not None:
                on_grads(g_dense, g_sel)
            new_params, new_opt = apply_updates_mixed(
                tc.optimizer, trainable, g_dense, g_sel, state["opt"], step,
                sel_idx, spec, sharded)
        else:
            loss, metrics = T.loss_fn(cfg, (frozen, t_tree), batch, sel=sel,
                                      remat=remat)
            (grads,) = _grads(loss, [t_tree])
            if data is not None:
                grads = _reduce_dense_scatter(grads, sel, data)
            if on_grads is not None:
                on_grads(grads, None)
            new_params, new_opt = apply_updates(tc.optimizer, trainable,
                                                grads, state["opt"], step,
                                                sharded)
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
        if data is not None:
            # each data shard's loss and metrics are its shares
            keys = sorted(metrics)
            total = SH.all_reduce_(torch.stack([metrics[k] for k in keys]),
                                   data, "metrics")
            metrics = dict(zip(keys, total.unbind(0)))
        return new_state, metrics

    return train_step


def _reduce_dense_scatter(grads, sel, data):
    """The dense-scatter (or dense) step's data-parallel reduction: the
    selectable leaves' full-shape gradients, or under compact_allreduce
    only their selected blocks; the other leaves as they are."""
    if sel is None or "segments" not in grads:
        return _reduce_tree(grads, data, "grad_full")
    sel_idx, spec = sel
    if compact_allreduce_enabled():
        grads = dict(grads)
        grads["segments"] = compress_grads(
            grads["segments"], sel_idx, spec,
            reduce=lambda t: SH.all_reduce_(t, data, "dw"))
        on_sel = lambda g: g
    else:
        on_sel = lambda g: SH.all_reduce_(g, data, "grad_full")
    return _map_split(grads, {"segments": spec}, on_sel,
                      lambda g: SH.all_reduce_(g, data, "grad_dense"))


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
