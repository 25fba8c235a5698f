"""Algorithm 1 — the three-phase dynamic gradient sparse update schedule.

    phase 0 (steps [0, j)):        fixed selection
    phase 1 (steps [j, j+k)):      DYNAMIC: a fresh random selection of the
                                   channel blocks every step
    phase 2 (steps [j+k, j+k+l)):  fixed again (convergence fine-tuning)

The step count lives on the host, so the phase is decided there; the draw
runs on the device and the indices stay there.
"""
from __future__ import annotations

from repro_torch.configs.base import SparseUpdateConfig
from repro_torch.core.selection import SelectionPlan, random_selection


def phase_of(step: int, sp: SparseUpdateConfig) -> int:
    if step < sp.phase_fixed_early:
        return 0
    if step < sp.phase_fixed_early + sp.phase_dynamic:
        return 1
    return 2


def maybe_reselect(plan: SelectionPlan, sp: SparseUpdateConfig, sel_idx,
                   step: int, seed: int, device="cuda"):
    """The selection for `step`: a fresh random one (a pure function of
    (seed, step)) inside the dynamic window, the incoming one otherwise."""
    if phase_of(step, sp) != 1:
        return sel_idx
    fresh = random_selection(plan, seed, step, device)
    return {seg: (None if old is None else fresh[seg])
            for seg, old in sel_idx.items()}


def coverage_after(plan: SelectionPlan, sp: SparseUpdateConfig,
                   num_steps: int) -> float:
    """Expected fraction of selectable blocks touched at least once after
    `num_steps` (paper Fig. 4 analogue: dynamic >> fixed coverage).

    Fixed phases touch n_sel/n_blocks once; each dynamic step re-draws."""
    from repro_torch.core.selection import _spec_leaves
    leaves = [sp_ for seg in plan.spec.values()
              for _, sp_ in _spec_leaves(seg)]
    if not leaves:
        return 0.0
    dyn_steps = max(0, min(num_steps - sp.phase_fixed_early, sp.phase_dynamic))
    total, covered = 0, 0.0
    for spc in leaves:
        nb = spc.n_blocks * spc.n_shards
        nsel = spc.n_sel * spc.n_shards
        p_fixed = nsel / nb
        p_dyn = 1.0 - (1.0 - nsel / nb) ** dyn_steps
        p = p_fixed + (1 - p_fixed) * p_dyn
        covered += p * nb
        total += nb
    return covered / total
