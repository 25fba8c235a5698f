"""Carry parameters and train state between the reference package and the port.

Both sides keep parameters as nested dicts with the same keys and the same
stacked [L, ...] layer layout, so the bridge only changes the array type:
numpy arrays (anything `np.asarray` takes, a JAX array included) to
tensors, and back. bf16 travels bit for bit (as int16 bits).

The train-state keys carried are `step`, `params_trainable`,
`params_frozen`, `opt` and `sel_idx`. The reference's `rng` is a JAX PRNG
key, which the port cannot replay; the port's `rng` is an int seed, given
on the way in (its dynamic-phase draws key on (seed, step, segment, leaf),
`core.selection.draw_seed`). `state_to_tree` / `state_from_tree` give the
port's train state the reference's checkpoint layout (`step` a 0-d int32,
no `rng`), so a train state saved by either package restores in the other.

Serve state (page pools, page tables, delta batches) is nested dicts of
arrays too, so `to_torch` / `to_numpy` carry it; a user's `DeltaState`
goes with `delta_to_torch` / `delta_to_numpy`.

On a mesh, `params_to_rank` / `state_to_rank` carry the reference's whole
params or train state to one rank's shards (`launch.specs.shard_local`
under the rules), and the selection to the rank's shards of it
(`core.selection.local_selection`).
"""
from __future__ import annotations

import numpy as np
import torch

STATE_KEYS = ("step", "params_trainable", "params_frozen", "opt", "sel_idx")


def to_torch(tree, device="cpu"):
    """Nested dict of arrays -> same dict of tensors on `device`; None stays
    None."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if tree is None:
        return None
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device)


def to_numpy(tree):
    """Nested dict of tensors -> same dict of numpy arrays (bf16 as the
    `ml_dtypes.bfloat16` numpy type JAX uses)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if tree is None:
        return None
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # JAX's numpy bf16 type; only the tests go this way
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def state_to_torch(state, seed: int = 0, device="cpu") -> dict:
    """A reference train state -> the port's (host-int step, tensors on
    `device`, `rng` = seed)."""
    out = {"step": int(np.asarray(state["step"]))}
    for key in STATE_KEYS[1:]:
        out[key] = to_torch(state[key], device)
    out["rng"] = seed
    return out


def state_to_numpy(state) -> dict:
    """The port's train state -> numpy arrays under the reference's keys
    (without `rng`)."""
    out = {"step": np.asarray(state["step"], np.int32)}
    for key in STATE_KEYS[1:]:
        out[key] = to_numpy(state[key])
    return out


def state_to_tree(state) -> dict:
    """The port's train state as a checkpoint tree in the reference's
    layout: `step` a 0-d int32 tensor, the tensors as they are, no `rng`."""
    out = {"step": torch.tensor(state["step"], dtype=torch.int32)}
    for key in STATE_KEYS[1:]:
        out[key] = state[key]
    return out


def state_from_tree(tree, seed: int = 0) -> dict:
    """A checkpoint tree (`state_to_tree`'s layout, or a reference train
    state restored onto it, whose JAX `rng` key is dropped) -> the port's
    train state, `rng` = seed."""
    out = {"step": int(tree["step"])}
    for key in STATE_KEYS[1:]:
        out[key] = tree.get(key)
    out["rng"] = seed
    return out


def delta_to_torch(state, device="cpu"):
    """A reference `DeltaState` (numpy or JAX leaves) -> the port's, with
    tensors on `device`."""
    from repro_torch.core.delta import DeltaState
    return DeltaState(idx=to_torch(state.idx, device),
                      vals=to_torch(state.vals, device))


def delta_to_numpy(state) -> dict:
    """The port's `DeltaState` -> {"idx", "vals"} trees of numpy arrays,
    the layout of the reference's `DeltaState.to_tree()`."""
    return to_numpy(state.to_tree())


def params_to_rank(params, cfg, rules, device="cpu"):
    """A whole param tree (numpy or JAX arrays) -> this rank's shards under
    `rules` (a process mesh's), as tensors on `device`."""
    from repro_torch.launch.specs import shard_local, tree_shardings
    from repro_torch.models.specs import param_logical_specs
    sh = tree_shardings(params, param_logical_specs(cfg), rules)
    return to_torch(shard_local(params, sh, rules.mesh.shape,
                                rules.mesh.coords), device)


def selection_to_rank(plan, sel_idx, rules, device="cpu"):
    """A selection in the plan's layout (numpy or JAX arrays) -> this
    rank's shards of it, as tensors on `device`."""
    from repro_torch.core.selection import local_selection
    shard = rules.mesh.coords[rules.model_axis] if rules.model_axis else 0
    sel = {seg: (None if t is None else _numpy_tree(t))
           for seg, t in sel_idx.items()}
    return to_torch(local_selection(plan, sel, shard), device)


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return None if tree is None else np.asarray(tree)


def state_to_rank(state, cfg, plan, rules, seed: int = 0, device="cpu"):
    """A reference train state -> this rank's (`state_to_torch` on the
    rank's shards of its params, optimizer state and selection)."""
    from repro_torch.launch.specs import shard_local, tree_shardings
    from repro_torch.models.specs import param_logical_specs
    logical = param_logical_specs(cfg)
    out = {"step": int(np.asarray(state["step"])), "rng": seed}
    for key in ("params_trainable", "params_frozen"):
        tree = _numpy_tree(state[key])
        out[key] = to_torch(shard_local(
            tree, tree_shardings(tree, logical, rules), rules.mesh.shape,
            rules.mesh.coords), device)
    out["opt"] = {}
    for key, tree in (state["opt"] or {}).items():
        tree = _numpy_tree(tree)
        out["opt"][key] = to_torch(shard_local(
            tree, tree_shardings(tree, logical, rules), rules.mesh.shape,
            rules.mesh.coords), device)
    out["sel_idx"] = None if state["sel_idx"] is None else \
        selection_to_rank(plan, state["sel_idx"], rules, device)
    return out
