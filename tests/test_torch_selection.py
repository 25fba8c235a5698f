"""The port's selection plan, selections, schedule and memory model against
the reference's, and the port's own random draws by their properties."""
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import SparseUpdateConfig as JSparse  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.core import memory as jmem  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro.core import selection as jsel  # noqa: E402
from repro.models.transformer import init_params as jinit  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import SparseUpdateConfig  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core import memory as pmem  # noqa: E402
from repro_torch.core import schedule as psched  # noqa: E402
from repro_torch.core import selection as psel  # noqa: E402
from repro_torch.core.sparse_update import SelSpec  # noqa: E402


def _configs(full: bool):
    if full:
        return jget_config("llama3-8b"), get_config("llama3-8b")
    return jget_smoke("llama3-8b"), get_smoke_config("llama3-8b")


def _sparse(**kw):
    return JSparse(**kw), SparseUpdateConfig(**kw)


def _as_tuples(spec_tree):
    return jax.tree.map(tuple, spec_tree,
                        is_leaf=lambda x: hasattr(x, "n_blocks"))


@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
@pytest.mark.parametrize("kw", [
    dict(update_ratio=0.2, num_update_layers=2, channel_block=128),
    dict(update_ratio=0.5, num_update_layers=2, channel_block=8),
    dict(update_ratio=0.3, num_update_layers=0, channel_block=16),
    dict(update_ratio=0.2, num_update_layers=0, channel_block=128,
         memory_budget_bytes=300 * 2**20),
])
def test_build_plan_matches_reference(full, kw):
    """Every SelSpec and seg_trainable equal the reference's; the full
    config's shapes come from the meta device there and eval_shape here."""
    jcfg, pcfg = _configs(full)
    jsp, psp = _sparse(**kw)
    tokens = 4 * 1024
    jplan = jsel.build_plan(jcfg, jsp, tokens)
    pplan = psel.build_plan(pcfg, psp, tokens)
    assert pplan.seg_trainable == jplan.seg_trainable
    assert _as_tuples(pplan.spec) == _as_tuples(jplan.spec)
    assert all(isinstance(s, SelSpec) for s in jax.tree.leaves(
        pplan.spec, is_leaf=lambda x: isinstance(x, SelSpec)))


@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
def test_selected_fraction_and_coverage_match_reference(full):
    jcfg, pcfg = _configs(full)
    jsp, psp = _sparse(update_ratio=0.2, num_update_layers=2,
                       channel_block=16, phase_fixed_early=3,
                       phase_dynamic=5)
    jplan, pplan = jsel.build_plan(jcfg, jsp), psel.build_plan(pcfg, psp)
    assert psel.selected_fraction(pplan, pcfg) == \
        pytest.approx(jsel.selected_fraction(jplan, jcfg), rel=1e-12)
    for steps in (0, 2, 4, 8, 20):
        assert psched.coverage_after(pplan, psp, steps) == pytest.approx(
            jsched.coverage_after(jplan, jsp, steps, jax.random.PRNGKey(0)),
            rel=1e-12)


def test_phase_of_matches_reference():
    jsp, psp = _sparse(phase_fixed_early=3, phase_dynamic=4)
    for step in range(12):
        assert psched.phase_of(step, psp) == jsched.phase_of(step, jsp)


@pytest.mark.parametrize("budget_mb", [0.05, 1.0, 4.0, 1e6])
def test_solve_max_layers_matches_reference(budget_mb):
    jcfg, pcfg = _configs(False)
    jsp, psp = _sparse(update_ratio=0.2,
                       memory_budget_bytes=int(budget_mb * 2**20))
    with warnings.catch_warnings():
        # an impossible budget warns on both sides and falls back to K=1
        warnings.simplefilter("ignore")
        want = jmem.solve_max_layers(jcfg, jsp, 256)
        got = pmem.solve_max_layers(pcfg, psp, 256)
    assert got == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_magnitude_selection_matches_reference(dtype):
    """Same params (bridged from the reference's init) -> the same blocks;
    ties break to the lower block index on both sides (stable argsort)."""
    jcfg = dataclasses.replace(jget_smoke("llama3-8b"), dtype=dtype)
    pcfg = dataclasses.replace(get_smoke_config("llama3-8b"), dtype=dtype)
    jsp, psp = _sparse(update_ratio=0.4, num_update_layers=2, channel_block=8)
    jparams = jinit(jcfg, jax.random.PRNGKey(1))
    want = jsel.magnitude_selection(jsel.build_plan(jcfg, jsp), jparams)
    got = psel.magnitude_selection(psel.build_plan(pcfg, psp),
                                   bridge.to_torch(jax.device_get(jparams)))
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(bridge.to_numpy(got))):
        np.testing.assert_array_equal(b, np.asarray(a))
        assert b.dtype == np.int32


def test_magnitude_selection_ties_keep_lower_index():
    plan = psel.SelectionPlan(
        seg_trainable={"blocks": 1},
        spec={"blocks": {"w": SelSpec(block=2, n_shards=1, n_sel=2,
                                      n_blocks=4)}},
        update_ratio=0.5, channel_block=2, seed=0)
    w = torch.ones(1, 3, 8)
    w[0, :, 6:] = 2.0
    got = psel.magnitude_selection(plan, {"segments": {"blocks": {"w": w}}})
    assert got["blocks"]["w"].tolist() == [[[3, 0]]]


def _plan(ratio=0.3, layers=2, block=8):
    return psel.build_plan(get_smoke_config("llama3-8b"), SparseUpdateConfig(
        update_ratio=ratio, num_update_layers=layers, channel_block=block))


def test_random_selection_valid_unique_and_pure():
    """In range, unique within a shard, shaped [K, n_shards, n_sel], int32,
    and a pure function of (seed, step): the same pair draws the same
    selection; another step draws another."""
    plan = _plan()
    draws = {step: psel.random_selection(plan, 7, step, "cpu")
             for step in range(4)}
    again = psel.random_selection(plan, 7, 2, "cpu")
    for a, b in zip(jax.tree.leaves(bridge.to_numpy(draws[2])),
                    jax.tree.leaves(bridge.to_numpy(again))):
        np.testing.assert_array_equal(a, b)
    specs = jax.tree.leaves(plan.spec["blocks"],
                            is_leaf=lambda x: isinstance(x, SelSpec))
    for step, d in draws.items():
        for sp, idx in zip(specs, jax.tree.leaves(bridge.to_numpy(d))):
            assert idx.dtype == np.int32
            assert idx.shape == (2, sp.n_shards, sp.n_sel)
            assert idx.min() >= 0 and idx.max() < sp.n_blocks
            for row in idx.reshape(-1, sp.n_sel):
                assert len(set(row.tolist())) == sp.n_sel
    flat = [np.concatenate([a.ravel() for a in
                            jax.tree.leaves(bridge.to_numpy(draws[s]))])
            for s in range(4)]
    assert all(not np.array_equal(flat[0], f) for f in flat[1:])
    other_seed = psel.random_selection(plan, 8, 2, "cpu")
    assert any(not np.array_equal(a, b) for a, b in zip(
        jax.tree.leaves(bridge.to_numpy(draws[2])),
        jax.tree.leaves(bridge.to_numpy(other_seed))))


def test_maybe_reselect_only_in_the_dynamic_phase():
    plan = _plan()
    sp = SparseUpdateConfig(update_ratio=0.3, num_update_layers=2,
                            channel_block=8, phase_fixed_early=2,
                            phase_dynamic=3)
    old = psel.random_selection(plan, 0, 0, "cpu")
    for step in range(7):
        new = psched.maybe_reselect(plan, sp, old, step, 0, "cpu")
        if psched.phase_of(step, sp) == 1:
            want = psel.random_selection(plan, 0, step, "cpu")
            for a, b in zip(jax.tree.leaves(bridge.to_numpy(new)),
                            jax.tree.leaves(bridge.to_numpy(want))):
                np.testing.assert_array_equal(a, b)
        else:
            assert new is old


def test_dynamic_coverage_grows_with_port_draws():
    """Empirical coverage of the port's draws over dynamic steps rises
    above the fixed selection's share (paper Fig. 4), as the analytic
    coverage_after says."""
    plan = _plan(ratio=0.25, layers=1, block=8)
    seen = None
    for step in range(12):
        d = bridge.to_numpy(psel.random_selection(plan, 3, step, "cpu"))
        idx = d["blocks"]["mlp"]["w_up"][0, 0]
        hit = np.zeros(plan.spec["blocks"]["mlp"]["w_up"].n_blocks, bool)
        hit[idx] = True
        seen = hit if seen is None else seen | hit
    spec = plan.spec["blocks"]["mlp"]["w_up"]
    assert seen.sum() > spec.n_sel
