"""The port's compact train step on the rwkv6-3b smoke config against the
reference's: same params and selection (from the reference, bridged), same
numpy batch, 3 steps with SGD, momentum and AdamW; compact against
dense-scatter inside the port; the structure of a step's kernel calls; the
counterparts of the reference's `test_compact_matches_dense_other_archs
[rwkv6-3b]` and `test_smoke_sparse_train_step`; and the CLI."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.train import make_train_state as jstate  # noqa: E402
from repro.train import make_train_step as jstep  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as PC  # noqa: E402
from repro_torch.core.selection import build_plan  # noqa: E402
from repro_torch.core.sparse_update import tree_leaves  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.train import make_train_state, make_train_step  # noqa: E402

ARCH = "rwkv6-3b"
OPTS = {"sgd": {}, "momentum": {"momentum": 0.9}, "adamw": {}}
# the selectable leaves of one rwkv layer: time wr wk wv wg wo, channel
# wk wv wr (u, mu, w0, wA, wB and the norms take the dense rule)
SELECTABLE = {"time": {"wr", "wk", "wv", "wg", "wo"},
              "chan": {"wk", "wv", "wr"}}


def _tcs(kind, sparse_kw=None, steps=16):
    sparse_kw = sparse_kw or dict(update_ratio=0.5, num_update_layers=2,
                                  channel_block=8)
    return [C.TrainConfig(
        model=C.get_smoke_config(ARCH),
        shape=C.ShapeConfig("t", steps, 4, "train"),
        sparse=C.SparseUpdateConfig(**sparse_kw),
        optimizer=C.OptimizerConfig(kind=kind, learning_rate=0.05,
                                    **OPTS[kind])) for C in (JC, PC)]


def _batch(seed=3, b=4, s=16):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, 256, (b, s)).astype(np.int32),
            "labels": rng.integers(0, 256, (b, s)).astype(np.int32)}


def _start(kind):
    jtc, ptc = _tcs(kind)
    js, jplan = jstate(jtc, jax.random.PRNGKey(0))
    pplan = build_plan(ptc.model, ptc.sparse, 64)
    return jtc, ptc, js, jplan, pplan


def _max_diff(a, b):
    return max(float(np.abs(np.asarray(x, np.float32)
                            - np.asarray(y, np.float32)).max())
               for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))


def test_plan_selects_eight_leaves_a_layer():
    _, _, _, jplan, pplan = _start("sgd")
    assert pplan.seg_trainable == jplan.seg_trainable == {"blocks": 2}
    assert {g: set(v) for g, v in pplan.spec["blocks"].items()} == SELECTABLE
    assert jax.tree.map(tuple, jplan.spec, is_leaf=lambda s: hasattr(
        s, "n_sel")) == jax.tree.map(tuple, pplan.spec,
                                     is_leaf=lambda s: hasattr(s, "n_sel"))


@pytest.mark.parametrize("compact", [True, False],
                         ids=["compact", "dense_scatter"])
@pytest.mark.parametrize("kind,tol", [
    ("sgd", 1e-5),
    ("momentum", 1e-5),
    # the reference's own bound for AdamW (test_compact_path): g/sqrt(g^2)
    # turns fp32 summation-order differences in near-zero gradients into
    # O(lr) update differences
    ("adamw", 1e-2),
])
def test_train_steps_match_reference(kind, tol, compact):
    """3 fixed-phase steps: losses (1e-5), trainable params (the dense-rule
    leaves u, mu, w0, wA, wB and the norms of the trainable layers too) and
    optimizer state against the reference's jitted step."""
    jtc, ptc, js, jplan, pplan = _start(kind)
    ps = bridge.state_to_torch(jax.device_get(js))
    jfn = jax.jit(jstep(jtc, jplan, compact_grads=compact))
    pfn = make_train_step(ptc, pplan, compact_grads=compact)
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for _ in range(3):
        js, jm = jfn(js, jb)
        ps, pm = pfn(ps, tb)
        assert float(pm["loss"]) == pytest.approx(float(jm["loss"]), abs=1e-5)
    got = bridge.state_to_numpy(ps)
    js = jax.device_get(js)
    for key in ("sel_idx", "params_frozen"):
        assert _max_diff(got[key], js[key]) == 0
    assert _max_diff(got["params_trainable"], js["params_trainable"]) <= tol
    assert jax.tree.structure(got["opt"]) == jax.tree.structure(js["opt"])
    if js["opt"]:
        assert _max_diff(got["opt"], js["opt"]) <= tol


def test_compact_equals_dense_scatter_bitwise_for_sgd():
    """Inside the port, SGD on the compact path equals the dense-scatter
    path bitwise (losses and every trainable leaf), 3 steps."""
    _, ptc, js, _, pplan = _start("sgd")
    start = jax.device_get(js)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    out = {}
    for compact in (True, False):
        s = bridge.state_to_torch(start)
        fn = make_train_step(ptc, pplan, compact_grads=compact)
        losses = []
        for _ in range(3):
            s, m = fn(s, batch)
            losses.append(float(m["loss"]))
        out[compact] = (losses, tree_leaves(s["params_trainable"]))
    assert out[True][0] == out[False][0]
    assert all(torch.equal(a, b) for a, b in zip(out[True][1], out[False][1]))


def test_compact_matches_dense_other_archs_rwkv():
    """The reference's `test_compact_matches_dense_other_archs[rwkv6-3b]`:
    momentum 0.9, 2 steps, compact within 1e-6 of dense-scatter."""
    _, ptc = _tcs("momentum")
    state, plan = make_train_state(ptc, device="cpu")
    start = dict(state)
    batch = {k: torch.from_numpy(v) for k, v in _batch(seed=7).items()}
    out = {}
    for compact in (False, True):
        s = dict(start, params_trainable=jax.tree.map(
            torch.clone, start["params_trainable"]),
            opt=jax.tree.map(torch.clone, start["opt"]))
        fn = make_train_step(ptc, plan, compact_grads=compact)
        for _ in range(2):
            s, _ = fn(s, batch)
        out[compact] = s
    diff = max(float((a.float() - b.float()).abs().max()) for a, b in zip(
        tree_leaves(out[False]["params_trainable"]),
        tree_leaves(out[True]["params_trainable"])))
    assert diff <= 1e-6


def test_smoke_sparse_train_step():
    """The reference's `test_smoke_sparse_train_step` for rwkv6-3b: one SGD
    step, loss finite, the frozen tree bitwise untouched, something moved,
    and in a selectable leaf only the selected blocks."""
    from repro_torch.core.sparse_update import (gather_param_blocks,
                                                scatter_param_blocks)
    ptc = _tcs("sgd", dict(update_ratio=0.5, num_update_layers=1,
                           channel_block=8, phase_fixed_early=100),
               steps=32)[1]
    ptc = dataclasses.replace(ptc, optimizer=PC.OptimizerConfig(
        kind="sgd", learning_rate=0.1))
    state, plan = make_train_state(ptc, device="cpu")
    frozen = [a.clone() for a in tree_leaves(state["params_frozen"])]
    before = [a.clone() for a in tree_leaves(state["params_trainable"])]
    wo = state["params_trainable"]["segments"]["blocks"]["time"]["wo"]
    wo0 = wo.clone()
    fn = make_train_step(ptc, plan, compact_grads=True)
    b = _batch(seed=1, b=2, s=32)
    state, m = fn(state, {k: torch.from_numpy(v) for k, v in b.items()})
    assert np.isfinite(float(m["loss"])) and state["step"] == 1
    assert all(torch.equal(a, b) for a, b in zip(
        frozen, tree_leaves(state["params_frozen"])))
    assert any(not torch.equal(a, b) for a, b in zip(
        before, tree_leaves(state["params_trainable"])))
    idx = state["sel_idx"]["blocks"]["time"]["wo"]
    spec = plan.spec["blocks"]["time"]["wo"]
    mask = scatter_param_blocks(
        torch.zeros_like(wo0), torch.ones_like(gather_param_blocks(
            wo0, idx, spec)), idx, spec).bool()
    assert torch.equal(wo[~mask], wo0[~mask])
    assert not torch.equal(wo[mask], wo0[mask])


def test_a_step_calls_each_kernel_wrapper_as_the_card_counts_it(monkeypatch):
    """On the CPU nothing launches, so count the wrapper calls instead. One
    compact step on L = 3 layers with K = 2 trainable: the WKV forward once
    a layer plus once more for each trainable layer (recomputed in backward
    under `torch.utils.checkpoint`), the WKV backward once per trainable
    layer, the dW once per selectable leaf and trainable layer (K x 8), the
    fused optimizer once per selectable stacked leaf (8). `chip_smoke.py`
    asserts these counts of launches on the card at full width."""
    calls = {}
    for name in ("wkv6_fwd", "wkv6_bwd", "block_sparse_dw",
                 "fused_block_opt"):
        real = getattr(ops, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **kw)
        monkeypatch.setattr(ops, name, counted)
    _, ptc = _tcs("adamw")
    state, plan = make_train_state(ptc, device="cpu")
    fn = make_train_step(ptc, plan, compact_grads=True)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    n_layers, k = ptc.model.num_layers, 2
    for _ in range(2):
        calls.clear()
        state, _ = fn(state, batch)
        assert calls == {"wkv6_fwd": n_layers + k, "wkv6_bwd": k,
                         "block_sparse_dw": k * 8, "fused_block_opt": 8}


def test_cli_runs_smoke_steps_on_cpu(capsys):
    from repro_torch.launch import train
    out = train.main(["--arch", ARCH, "--smoke", "--steps", "3", "--batch",
                      "2", "--seq", "16", "--update-layers", "2",
                      "--compact-grads", "--channel-block", "8",
                      "--phase-j", "1", "--phase-k", "1", "--log-every", "1",
                      "--device", "cpu"])
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    assert out["state"]["step"] == 3
    text = capsys.readouterr().out
    assert "DGSU plan" in text and "step     3" in text
