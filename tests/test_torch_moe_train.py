"""The port's MoE compact train step against the reference's on the
deepseek-moe-16b smoke config (a dense first layer plus MoE layers), with
the reference's MoE compact-path settings (`_moe_tc` in
tests/test_compact_path.py): same params and selection (from the
reference, bridged), same numpy batch, 3 steps. Plus the selection plan of
the MoE config, the bridge, the port's own guarantees and its CLI."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from repro_torch.testing import limit_threads  # noqa: E402

limit_threads()
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.core import selection as jsel  # noqa: E402
from repro.train import make_train_state as jstate  # noqa: E402
from repro.train import make_train_step as jstep  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as PC  # noqa: E402
from repro_torch.core import selection as psel  # noqa: E402
from repro_torch.core.sparse_update import (SelSpec, gather_param_blocks,  # noqa: E402
                                            tree_leaves, tree_map)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import scatter_blocks3  # noqa: E402
from repro_torch.models import moe as PMOE  # noqa: E402
from repro_torch.train import make_train_state, make_train_step  # noqa: E402

ARCH = "deepseek-moe-16b"
OPTS = {"sgd": {}, "momentum": {"momentum": 0.9}, "adamw": {}}
EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def _tcs(kind="momentum", num_layers=None):
    """The same TrainConfig in both packages: the smoke config (optionally
    deeper) with the reference's `_moe_tc` sparse and optimizer settings."""
    out = []
    for C in (JC, PC):
        cfg = C.get_smoke_config(ARCH)
        if num_layers:
            cfg = dataclasses.replace(cfg, num_layers=num_layers)
        out.append(C.TrainConfig(
            model=cfg, shape=C.ShapeConfig("t", 16, 4, "train"),
            sparse=C.SparseUpdateConfig(update_ratio=0.5,
                                        num_update_layers=2,
                                        channel_block=8),
            optimizer=C.OptimizerConfig(kind=kind, learning_rate=0.05,
                                        **OPTS[kind])))
    return out


def _batch(seed=3):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, 256, (4, 16)).astype(np.int32),
            "labels": rng.integers(0, 256, (4, 16)).astype(np.int32)}


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _max_diff(a, b):
    return max(float(np.abs(np.asarray(x, np.float32)
                            - np.asarray(y, np.float32)).max())
               for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))


def _as_tuples(spec_tree):
    return jax.tree.map(tuple, spec_tree,
                        is_leaf=lambda x: hasattr(x, "n_blocks"))


@pytest.fixture
def near_tie_probe(monkeypatch):
    """Wraps the port's apply_moe to record, for every routed token of
    every MoE call, the gap between its k-th and (k+1)-th router
    probability; the test fails on a gap below 1e-5, where one ulp of the
    fp32 logits can route the token differently in the two frameworks."""
    gaps = []
    inner = PMOE.apply_moe

    def probed(p, cfg, x, sel=None):
        with torch.no_grad():
            _, probs, _, _ = PMOE.route(p["router"], x.reshape(-1, x.shape[-1]),
                                        cfg.moe.top_k + 1)
            top = torch.topk(probs, cfg.moe.top_k + 1, dim=-1).values
            gaps.append(float((top[:, -2] - top[:, -1]).min()))
        return inner(p, cfg, x, sel)

    monkeypatch.setattr(PMOE, "apply_moe", probed)
    yield gaps
    assert gaps and min(gaps) >= 1e-5, (
        f"a routed token has a top-k near-tie (gap {min(gaps)} < 1e-5): "
        f"pick another seed rather than loosen the comparison")


# ---------------------------------------------------------------------------
# plan and bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
@pytest.mark.parametrize("kw", [
    dict(update_ratio=0.2, num_update_layers=2, channel_block=128),
    dict(update_ratio=0.5, num_update_layers=2, channel_block=8),
])
def test_moe_plan_matches_reference(full, kw):
    """Every SelSpec (attention, moe/w_gate, w_up, w_down [K, E, d, N],
    moe/shared/*, and the dense first layer's) and seg_trainable equal the
    reference's; the router has none, so it takes the plain optimizer."""
    get_j = JC.get_config if full else JC.get_smoke_config
    get_p = PC.get_config if full else PC.get_smoke_config
    jplan = jsel.build_plan(get_j(ARCH), JC.SparseUpdateConfig(**kw), 4096)
    pplan = psel.build_plan(get_p(ARCH), PC.SparseUpdateConfig(**kw), 4096)
    assert pplan.seg_trainable == jplan.seg_trainable
    assert _as_tuples(pplan.spec) == _as_tuples(jplan.spec)
    moe = pplan.spec["blocks"]["moe"]
    assert set(moe) == {"w_gate", "w_up", "w_down", "shared"}
    assert all(isinstance(s, SelSpec) for s in
               (moe["w_gate"], moe["w_up"], moe["w_down"]))
    assert "router" not in moe


def test_first_segment_frozen_for_every_k_up_to_27():
    """The dense first layer trains only when all 28 layers do."""
    cfg = PC.get_config(ARCH)
    for k in range(1, 29):
        plan = psel.build_plan(cfg, PC.SparseUpdateConfig(
            num_update_layers=k, channel_block=128))
        assert plan.seg_trainable == {"blocks": min(k, 27),
                                      "first": max(0, k - 27)}, k
    ref_plan = jsel.build_plan(JC.get_config(ARCH), JC.SparseUpdateConfig(
        num_update_layers=27, channel_block=128))
    assert ref_plan.seg_trainable["first"] == 0


def test_bridge_carries_the_moe_state():
    """The reference's MoE train state (bf16 model, fp32 router, the dense
    `first` segment, momentum state, selection) to the port and back, bit
    for bit, with the router still fp32."""
    jtc, _ = _tcs("momentum", num_layers=5)
    jtc = dataclasses.replace(jtc, model=dataclasses.replace(
        jtc.model, dtype="bfloat16"))
    js, _ = jstate(jtc, jax.random.PRNGKey(0))
    js = jax.device_get(js)
    ps = bridge.state_to_torch(js)
    assert ps["params_frozen"]["segments"]["first"]["mlp"]["w_gate"].dtype \
        == torch.bfloat16
    for tree in ("params_frozen", "params_trainable"):
        assert ps[tree]["segments"]["blocks"]["moe"]["router"].dtype \
            == torch.float32
    back = bridge.state_to_numpy(ps)
    for key in ("params_frozen", "params_trainable", "opt", "sel_idx"):
        assert jax.tree.structure(back[key]) == jax.tree.structure(js[key])
        for a, b in zip(jax.tree.leaves(back[key]), jax.tree.leaves(js[key])):
            assert a.dtype == b.dtype and np.array_equal(
                a.view(np.uint8), np.asarray(b).view(np.uint8))


# ---------------------------------------------------------------------------
# the train step against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,tol", [
    ("sgd", 1e-5),
    ("momentum", 1e-5),
    # the reference's own bound for AdamW (test_compact_path): g/sqrt(g^2)
    # turns fp32 summation-order differences in near-zero gradients into
    # O(lr) update differences
    ("adamw", 1e-2),
])
def test_moe_compact_steps_match_reference(kind, tol, near_tie_probe):
    """3 compact steps: losses and the aux metrics (1e-5), the updated
    trainable params (expert leaves, router, shared experts, attention)
    and the optimizer state, against the reference's jitted compact step,
    in f32."""
    jtc, ptc = _tcs(kind)
    js, jplan = jstate(jtc, jax.random.PRNGKey(0))
    pplan = psel.build_plan(ptc.model, ptc.sparse, 64)
    ps = bridge.state_to_torch(jax.device_get(js))
    jfn = jax.jit(jstep(jtc, jplan, compact_grads=True))
    pfn = make_train_step(ptc, pplan, compact_grads=True)
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for _ in range(3):
        js, jm = jfn(js, jb)
        ps, pm = pfn(ps, _tbatch(batch))
        assert set(pm) == set(jm)
        for key in ("loss", "ce", "load_balance", "router_z"):
            assert float(pm[key]) == pytest.approx(float(jm[key]), abs=1e-5,
                                                   rel=1e-5), key
    got = bridge.state_to_numpy(ps)
    js = jax.device_get(js)
    assert jax.tree.structure(got["params_trainable"]) == \
        jax.tree.structure(js["params_trainable"])
    assert _max_diff(got["params_trainable"], js["params_trainable"]) <= tol
    assert jax.tree.structure(got["opt"]) == jax.tree.structure(js["opt"])
    if js["opt"]:
        assert _max_diff(got["opt"], js["opt"]) <= tol


@pytest.mark.parametrize("kind,tol", [("sgd", 0.0), ("momentum", 1e-6)])
def test_moe_compact_matches_dense_scatter(kind, tol):
    """In the port: 2 fixed-phase steps of the compact path against the
    dense-scatter path from one start; SGD bitwise, momentum 1e-6 (the
    reference's own bounds)."""
    _, ptc = _tcs(kind, num_layers=5)
    sc, plan = make_train_state(ptc, device="cpu")
    sd = dict(sc, params_trainable=tree_map(torch.clone,
                                            sc["params_trainable"]),
              opt=tree_map(torch.clone, sc["opt"]))
    fc = make_train_step(ptc, plan, compact_grads=True)
    fd = make_train_step(ptc, plan, compact_grads=False)
    for _ in range(2):
        sc, mc = fc(sc, _tbatch(_batch()))
        sd, md = fd(sd, _tbatch(_batch()))
        assert float(mc["loss"]) == float(md["loss"])
    for a, b in zip(tree_leaves(sc["params_trainable"]),
                    tree_leaves(sd["params_trainable"])):
        assert float((a - b).abs().max()) <= tol
    for a, b in zip(tree_leaves(sc["opt"]), tree_leaves(sd["opt"])):
        assert float((a - b).abs().max()) <= tol


def test_moe_frozen_and_unselected_blocks_unchanged():
    """2 compact steps in the first fixed phase, momentum from zero: the
    `first` segment and the frozen MoE layers bitwise unchanged; every
    expert leaf's unselected blocks bitwise unchanged in every expert,
    its selected blocks moved."""
    _, ptc = _tcs("momentum", num_layers=5)
    state, plan = make_train_state(ptc, device="cpu")
    frozen0 = tree_map(torch.clone, state["params_frozen"])
    train0 = tree_map(torch.clone, state["params_trainable"])
    assert plan.seg_trainable == {"blocks": 2, "first": 0}
    step = make_train_step(ptc, plan, compact_grads=True)
    for _ in range(2):
        state, m = step(state, _tbatch(_batch()))
        assert bool(torch.isfinite(m["loss"]))
    assert "first" in state["params_frozen"]["segments"]
    for a, b in zip(tree_leaves(frozen0), tree_leaves(state["params_frozen"])):
        assert torch.equal(a, b)
    moe0 = train0["segments"]["blocks"]["moe"]
    moe1 = state["params_trainable"]["segments"]["blocks"]["moe"]
    for name in EXPERT_LEAVES:
        spec = plan.spec["blocks"]["moe"][name]
        idx = state["sel_idx"]["blocks"]["moe"][name]
        mask = torch.zeros_like(moe0[name], dtype=torch.bool)
        ones = torch.ones_like(gather_param_blocks(mask, idx, spec))
        k, n = mask.shape[0], mask.shape[-1]
        mask = scatter_blocks3(mask.reshape(k, -1, n),
                               ones.reshape((k, -1) + ones.shape[-3:]),
                               idx, spec.block).reshape(mask.shape)
        assert torch.equal(moe1[name][~mask], moe0[name][~mask]), name
        for e in range(moe0[name].shape[1]):      # every expert moved
            sel = mask[:, e]
            assert not torch.equal(moe1[name][:, e][sel],
                                   moe0[name][:, e][sel]), (name, e)
    assert not torch.equal(moe1["router"], moe0["router"])


def test_moe_dynamic_draws_unique_and_covering():
    """The dynamic phase's draws on the expert leaves: distinct blocks per
    (layer, shard), a fresh draw each step, and every block drawn within a
    few steps."""
    _, ptc = _tcs("momentum", num_layers=5)
    plan = psel.build_plan(ptc.model, ptc.sparse)
    seen = {name: set() for name in EXPERT_LEAVES}
    prev = None
    for step in range(12):
        draw = psel.random_selection(plan, seed=0, step=step, device="cpu")
        moe = draw["blocks"]["moe"]
        for name in EXPERT_LEAVES:
            spec = plan.spec["blocks"]["moe"][name]
            idx = moe[name]
            assert tuple(idx.shape) == (2, spec.n_shards, spec.n_sel)
            assert idx.dtype == torch.int32
            for row in idx.reshape(-1, spec.n_sel):
                assert len(set(row.tolist())) == spec.n_sel
                assert 0 <= int(row.min()) and int(row.max()) < spec.n_blocks
            seen[name].update(idx[0, 0].tolist())
        if prev is not None:
            assert any(not torch.equal(moe[n], prev[n])
                       for n in EXPERT_LEAVES)
        prev = moe
    for name in EXPERT_LEAVES:
        assert seen[name] == set(range(
            plan.spec["blocks"]["moe"][name].n_blocks)), name


def test_moe_cli_runs_on_cpu(capsys):
    """`python -m repro_torch.launch.train --arch deepseek-moe-16b --smoke
    --device cpu --compact-grads`: finite losses through the fixed and
    dynamic phases, no kernel launched on the CPU."""
    from repro_torch.launch import train
    ops.reset_launch_counts()
    out = train.main(["--arch", ARCH, "--smoke", "--steps", "4", "--batch",
                      "2", "--seq", "16", "--update-layers", "2",
                      "--compact-grads", "--channel-block", "8",
                      "--phase-j", "1", "--phase-k", "2", "--device", "cpu",
                      "--log-every", "1"])
    assert len(out["losses"]) == 4
    assert all(np.isfinite(out["losses"]))
    assert sum(ops.launch_counts().values()) == 0
    assert "[train] step     4" in capsys.readouterr().out
