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
