"""The port's compact deltas against the reference's: `decode_delta_spec`,
`zeros_delta_tree`, `apply_delta_tree` / `extract_delta_tree`, the
`DeltaStore` discipline on the same random operation sequences, and the
online train wave (`make_online_wave`): its new delta and its loss, from the
reference's params and per-user selection carried over through numpy.

Tolerances: the delta algebra is exact (a gather, an fp32 add and a cast).
The wave holds to 1e-5 in the loss and 1e-6 in the delta (lr 0.05 times
gradients whose sums run in another order), in f32: the reference's bf16
wave does not run on XLA's CPU backend (its dot thunk has no
bf16 x bf16 -> f32), so the bf16 cases are the exact delta algebra's."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as JCF  # noqa: E402
from repro.core import build_plan as jbuild_plan  # noqa: E402
from repro.core import delta as JDL  # noqa: E402
from repro.core import random_selection as jrandom_selection  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve import DeltaStore as JDeltaStore  # noqa: E402
from repro.train.steps import make_online_wave as jmake_wave  # noqa: E402
from repro.train.steps import split_params as jsplit  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as PCF  # noqa: E402
from repro_torch.core import delta as PDL  # noqa: E402
from repro_torch.core.selection import build_plan  # noqa: E402
from repro_torch.core.sparse_update import tree_leaves  # noqa: E402
from repro_torch.serve import DeltaStore  # noqa: E402
from repro_torch.train.steps import make_online_wave, split_params  # noqa: E402


def _sparse(C):
    return C.SparseUpdateConfig(update_ratio=0.5, num_update_layers=2,
                                channel_block=8)


def _setup(dtype="float32"):
    """Reference and port: config, plan pruned to the decode spec, the
    (frozen, trainable) split of the reference's params, and one user's
    selection drawn by the reference."""
    jcfg = dataclasses.replace(JCF.get_smoke_config("llama3-8b"), dtype=dtype)
    pcfg = dataclasses.replace(PCF.get_smoke_config("llama3-8b"), dtype=dtype)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    jplan = jbuild_plan(jcfg, _sparse(JCF), 0)
    jfrozen, jtrain = jsplit(jparams, jplan)
    jspec = JDL.decode_delta_spec(jplan, jtrain["segments"])
    jplan = dataclasses.replace(jplan, spec=jspec)
    jidx = jrandom_selection(jplan, jax.random.PRNGKey(1))
    jidx = {seg: jidx[seg] for seg in jspec}

    tparams = bridge.to_torch(jax.device_get(jparams))
    plan = build_plan(pcfg, _sparse(PCF), 0)
    frozen, train = split_params(tparams, plan)
    spec = PDL.decode_delta_spec(plan, train["segments"])
    plan = dataclasses.replace(plan, spec=spec)
    idx = bridge.to_torch(jax.device_get(jidx))
    return dict(jcfg=jcfg, pcfg=pcfg, jplan=jplan, jfrozen=jfrozen,
                jtrain=jtrain, jidx=jidx, plan=plan, frozen=frozen,
                train=train, idx=idx)


def _random_vals(s, seed=2):
    """Nonzero deltas of the right shapes (numpy), the same on both sides."""
    zeros = JDL.zeros_delta_tree(s["jtrain"]["segments"], s["jidx"],
                                 s["jplan"].spec, xp=np)
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (0.01 * rng.normal(size=a.shape)).astype(np.float32), zeros)


def _max_diff(a, b):
    return max(float(np.abs(np.asarray(x, np.float32)
                            - np.asarray(y, np.float32)).max())
               for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))


def test_decode_delta_spec_and_zeros_match_reference():
    s = _setup()
    assert s["plan"].spec.keys() == s["jplan"].spec.keys()
    jl = jax.tree_util.tree_leaves_with_path(
        s["jplan"].spec, is_leaf=lambda x: isinstance(x, tuple))
    for seg, tree in s["plan"].spec.items():
        for group, leaves in tree.items():
            assert set(leaves) == set(s["jplan"].spec[seg][group])
            for name, sp in leaves.items():
                assert tuple(sp) == tuple(s["jplan"].spec[seg][group][name])
    assert jl
    jz = JDL.zeros_delta_tree(s["jtrain"]["segments"], s["jidx"],
                              s["jplan"].spec, xp=np)
    pz = PDL.zeros_delta_tree(s["train"]["segments"], s["idx"],
                              s["plan"].spec)
    for a, b in zip(jax.tree.leaves(jz), jax.tree.leaves(bridge.to_numpy(pz))):
        assert b.shape == a.shape and b.dtype == np.float32
        assert not b.any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_and_extract_delta_tree_match_reference(dtype):
    """Materialize base + delta and extract it again: exactly the
    reference's on both, and the base tree is never written."""
    s = _setup(dtype)
    vals = _random_vals(s)
    japplied = JDL.apply_delta_tree(s["jtrain"]["segments"],
                                    jax.tree.map(jnp.asarray, vals),
                                    s["jidx"], s["jplan"].spec)
    before = [t.clone() for t in tree_leaves(s["train"]["segments"])]
    applied = PDL.apply_delta_tree(s["train"]["segments"],
                                   bridge.to_torch(vals), s["idx"],
                                   s["plan"].spec)
    assert _max_diff(bridge.to_numpy(applied), japplied) == 0.0
    assert all(torch.equal(a, b) for a, b in
               zip(before, tree_leaves(s["train"]["segments"])))
    jback = JDL.extract_delta_tree(s["jtrain"]["segments"], japplied,
                                   s["jidx"], s["jplan"].spec)
    back = PDL.extract_delta_tree(s["train"]["segments"], applied, s["idx"],
                                  s["plan"].spec)
    assert _max_diff(bridge.to_numpy(back), jback) == 0.0


# ---------------------------------------------------------------------------
# the delta store
# ---------------------------------------------------------------------------

def _apply(store, op, user):
    """One store operation; returns what it returned or the exception's
    type."""
    try:
        if op == 0:
            return store.admit(user)
        if op == 1:
            return store.release(user)
        if op == 2:
            return store.evict_lru()
        if op == 3:
            return store.put(user, {"user": user, "ver": 1})
        return store.get(user)
    except (RuntimeError, KeyError) as e:
        return type(e)


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("capacity", [1, 2, 4])
def test_delta_store_matches_reference_on_random_ops(seed, capacity):
    """The same random admit / release / evict / put / get sequence on the
    port's store and the reference's: the same results, exceptions, LRU
    order, pins and counters after every operation."""
    rng = np.random.default_rng(seed * 10 + capacity)
    make = lambda u: {"user": u}
    ours = DeltaStore(capacity, make, nbytes=lambda e: 8)
    ref = JDeltaStore(capacity, make, nbytes=lambda e: 8)
    for _ in range(120):
        op, user = int(rng.integers(0, 5)), int(rng.integers(0, 6))
        assert _apply(ours, op, user) == _apply(ref, op, user)
        ours.check()
        assert ours.users() == ref.users()
        assert [ours.ref(u) for u in range(6)] == [ref.ref(u)
                                                    for u in range(6)]
        assert (ours.hits, ours.misses, ours.evictions,
                ours.resident_bytes) == (ref.hits, ref.misses,
                                         ref.evictions, ref.resident_bytes)


# ---------------------------------------------------------------------------
# the online train wave
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("start", ["zero", "nonzero"])
def test_online_wave_matches_reference(start):
    """One wave from the same base, selection, delta and token stream: the
    new delta and the (pre-update) loss against the reference's; the
    port's base params stay bitwise as they were."""
    s = _setup()
    opt = lambda C: C.OptimizerConfig(kind="sgd", learning_rate=0.05)
    vals = _random_vals(s) if start == "nonzero" else jax.tree.map(
        np.zeros_like, _random_vals(s))
    rng = np.random.default_rng(3)
    stream = rng.integers(0, s["jcfg"].vocab_size, 9).astype(np.int32)
    batch = {"tokens": stream[None, :-1], "labels": stream[None, 1:]}

    jwave = jax.jit(jmake_wave(s["jcfg"], _sparse(JCF), opt(JCF),
                               s["jplan"], wave_tokens=8))
    jnew, jm = jwave(s["jtrain"], s["jfrozen"],
                     jax.tree.map(jnp.asarray, vals), s["jidx"],
                     {k: jnp.asarray(v) for k, v in batch.items()},
                     jax.random.PRNGKey(4))
    wave = make_online_wave(s["pcfg"], _sparse(PCF), opt(PCF), s["plan"],
                            wave_tokens=8)
    before = [t.clone() for t in tree_leaves(s["train"])
              + tree_leaves(s["frozen"])]
    new, m = wave(s["train"], s["frozen"], bridge.to_torch(vals), s["idx"],
                  {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5
    assert _max_diff(bridge.to_numpy(new), jnew) <= 1e-6
    assert any(bool(t.any()) for t in tree_leaves(new))
    after = tree_leaves(s["train"]) + tree_leaves(s["frozen"])
    assert all(torch.equal(a, b) for a, b in zip(before, after)), \
        "the wave wrote the shared base params"


def test_online_wave_refuses_stateful_optimizers_and_reselection():
    s = _setup()
    with pytest.raises(AssertionError, match="momentum 0"):
        make_online_wave(s["pcfg"], _sparse(PCF),
                         PCF.OptimizerConfig(kind="adamw"), s["plan"],
                         wave_tokens=8)
    with pytest.raises(AssertionError, match="phase_fixed_early"):
        make_online_wave(s["pcfg"], dataclasses.replace(
            _sparse(PCF), phase_fixed_early=0),
            PCF.OptimizerConfig(kind="sgd"), s["plan"], wave_tokens=8)
