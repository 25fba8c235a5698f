"""The port's train step against the reference's on the llama3 smoke config:
same params and selection (from the reference, bridged), same numpy batch,
3 steps with SGD, momentum and AdamW on the compact and the dense-scatter
paths; plus the port's own guarantees and its CLI."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from repro_torch.testing import limit_threads  # noqa: E402

limit_threads()
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.train import make_train_state as jstate  # noqa: E402
from repro.train import make_train_step as jstep  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as PC  # noqa: E402
from repro_torch.core.selection import build_plan  # noqa: E402
from repro_torch.core.sparse_update import tree_leaves  # noqa: E402
from repro_torch.train import make_train_state, make_train_step  # noqa: E402

OPTS = {"sgd": {}, "momentum": {"momentum": 0.9}, "adamw": {}}


def _tcs(kind, sparse_kw=None):
    """The same TrainConfig in both packages (the reference's compact-path
    test config)."""
    sparse_kw = sparse_kw or dict(update_ratio=0.5, num_update_layers=2,
                                  channel_block=8)
    out = []
    for C in (JC, PC):
        out.append(C.TrainConfig(
            model=C.get_smoke_config("llama3-8b"),
            shape=C.ShapeConfig("t", 16, 4, "train"),
            sparse=C.SparseUpdateConfig(**sparse_kw),
            optimizer=C.OptimizerConfig(kind=kind, learning_rate=0.05,
                                        **OPTS[kind])))
    return out


def _batch(seed=3):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, 256, (4, 16)).astype(np.int32),
            "labels": rng.integers(0, 256, (4, 16)).astype(np.int32)}


def _start(kind):
    """Reference state and plan, and the port's state bridged from it."""
    jtc, ptc = _tcs(kind)
    js, jplan = jstate(jtc, jax.random.PRNGKey(0))
    pplan = build_plan(ptc.model, ptc.sparse, 64)
    return jtc, ptc, js, jplan, pplan


def _max_diff(a, b):
    return max(float(np.abs(np.asarray(x, np.float32)
                            - np.asarray(y, np.float32)).max())
               for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))


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
    """3 steps: losses (1e-5), trainable params and optimizer state against
    the reference's jitted step."""
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
    assert ps["step"] == int(js["step"]) == 3
    got = bridge.state_to_numpy(ps)
    js = jax.device_get(js)
    assert _max_diff(got["params_trainable"], js["params_trainable"]) <= tol
    assert jax.tree.structure(got["opt"]) == jax.tree.structure(js["opt"])
    if js["opt"]:
        assert _max_diff(got["opt"], js["opt"]) <= tol


def test_dense_step_matches_reference():
    """The dense form (sparse update off: every layer and every block
    trains), 2 SGD steps against the reference's jitted step."""
    jtc, ptc = _tcs("sgd")
    jtc = dataclasses.replace(jtc, sparse=dataclasses.replace(
        jtc.sparse, enabled=False))
    ptc = dataclasses.replace(ptc, sparse=dataclasses.replace(
        ptc.sparse, enabled=False))
    js, jplan = jstate(jtc, jax.random.PRNGKey(0))
    assert js["sel_idx"] is None and not js["params_frozen"]["segments"]
    ps = bridge.state_to_torch(jax.device_get(js))
    pstate, pplan = make_train_state(ptc, params=bridge.to_torch(
        jax.device_get({**js["params_frozen"],
                        **js["params_trainable"]})), device="cpu")
    assert pplan.seg_trainable == jplan.seg_trainable
    assert pstate["sel_idx"] is None
    jfn = jax.jit(jstep(jtc, jplan))
    pfn = make_train_step(ptc, pplan)
    batch = _batch()
    for _ in range(2):
        js, jm = jfn(js, {k: jnp.asarray(v) for k, v in batch.items()})
        ps, pm = pfn(ps, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert float(pm["loss"]) == pytest.approx(float(jm["loss"]), abs=1e-5)
    assert _max_diff(bridge.state_to_numpy(ps)["params_trainable"],
                     jax.device_get(js)["params_trainable"]) <= 1e-5


@pytest.mark.parametrize("warmup,decay", [(0, 0), (3, 0), (2, 10), (0, 7)])
def test_learning_rate_matches_reference(warmup, decay):
    """Warmup and cosine decay, computed in fp32 on both sides: equal to an
    fp32 ulp (cos may round differently between XLA and PyTorch)."""
    from repro.optim import learning_rate as jlr
    from repro_torch.optim import learning_rate as plr
    jo = JC.OptimizerConfig(learning_rate=0.05, warmup_steps=warmup,
                            decay_steps=decay)
    po = PC.OptimizerConfig(learning_rate=0.05, warmup_steps=warmup,
                            decay_steps=decay)
    for step in range(12):
        got = plr(po, step)
        assert got.dtype == torch.float32
        np.testing.assert_array_max_ulp(got.numpy(),
                                        np.asarray(jlr(jo, step)), maxulp=1)


def test_clip_by_global_norm_matches_reference():
    from repro.optim import clip_by_global_norm as jclip
    from repro_torch.optim import clip_by_global_norm as pclip
    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "b": {"c": rng.normal(size=(5,)).astype(np.float32)}}
    for max_norm in (0.5, 100.0):
        jt, jn = jclip(jax.tree.map(jnp.asarray, tree), max_norm)
        pt, pn = pclip(bridge.to_torch(tree), max_norm)
        assert float(pn) == pytest.approx(float(jn), rel=1e-6)
        for a, b in zip(jax.tree.leaves(jt),
                        jax.tree.leaves(bridge.to_numpy(pt))):
            np.testing.assert_allclose(b, np.asarray(a), rtol=1e-6)


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


def test_compact_dynamic_phase_trains():
    """Dynamic reselection every step: the selection changes, only the
    drawn blocks move, the loss stays finite."""
    from repro_torch.core.sparse_update import (gather_param_blocks,
                                                scatter_param_blocks)
    ptc = _tcs("sgd", dict(update_ratio=0.3, num_update_layers=2,
                           channel_block=8, phase_fixed_early=0,
                           phase_dynamic=100))[1]
    state, plan = make_train_state(ptc, device="cpu")
    fn = make_train_step(ptc, plan, compact_grads=True)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    spec = plan.spec["blocks"]["mlp"]["w_up"]
    sels = []
    for _ in range(3):
        before = state["params_trainable"]["segments"]["blocks"]["mlp"][
            "w_up"].clone()
        state, m = fn(state, batch)
        assert np.isfinite(float(m["loss"]))
        after = state["params_trainable"]["segments"]["blocks"]["mlp"]["w_up"]
        idx = state["sel_idx"]["blocks"]["mlp"]["w_up"]
        sels.append(idx.clone())
        ones = torch.ones_like(gather_param_blocks(after, idx, spec))
        mask = scatter_param_blocks(torch.zeros_like(after), ones, idx,
                                    spec).bool()
        assert torch.equal(after[~mask], before[~mask])
        assert not torch.equal(after[mask], before[mask])
    assert not torch.equal(sels[0], sels[1])
    assert not torch.equal(sels[1], sels[2])


def test_state_bridge_round_trip():
    jtc, _, js, _, _ = _start("adamw")
    start = jax.device_get(js)
    back = bridge.state_to_numpy(bridge.state_to_torch(start, seed=5))
    assert int(back["step"]) == int(start["step"])
    for key in ("params_trainable", "params_frozen", "opt", "sel_idx"):
        a, b = jax.tree.leaves(start[key]), jax.tree.leaves(back[key])
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(np.asarray(x), y)
    bf = jnp.asarray([1.5, -2.25, 3e-3], jnp.bfloat16)
    t = bridge.to_torch(np.asarray(bf))
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(bridge.to_numpy(t), np.asarray(bf))


def test_cli_runs_smoke_steps_on_cpu(capsys):
    from repro_torch.launch import train
    out = train.main(["--arch", "llama3-8b", "--smoke", "--steps", "3",
                      "--batch", "2", "--seq", "16", "--update-layers", "2",
                      "--compact-grads", "--channel-block", "8",
                      "--phase-j", "1", "--phase-k", "1", "--log-every", "1",
                      "--device", "cpu"])
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    assert out["state"]["step"] == 3
    text = capsys.readouterr().out
    assert "DGSU plan" in text and "step     3" in text


def test_cli_refuses_checkpointing(tmp_path, capsys):
    """(The name is the test's from before checkpointing was ported.) The
    launcher checkpoints and resumes: a run SIGTERMed after step 3 saves
    an emergency checkpoint and stops; the same command again prints
    "resumed from step 3" and runs steps 4-6, which give bitwise the losses,
    trainable params and optimizer state of 6 straight steps (through the
    dynamic phase, steps 2-3: its draws key on the step)."""
    import os
    import signal
    from repro_torch.launch import train
    argv = ["--arch", "llama3-8b", "--smoke", "--steps", "6", "--batch", "2",
            "--seq", "16", "--update-layers", "2", "--compact-grads",
            "--channel-block", "8", "--phase-j", "1", "--phase-k", "2",
            "--optimizer", "adamw", "--log-every", "1", "--device", "cpu",
            "--ckpt-every", "2"]
    straight = train.main(argv + ["--ckpt-dir", str(tmp_path / "a")])

    def stop_at_3(step, state, metrics):
        if step == 3:
            os.kill(os.getpid(), signal.SIGTERM)
    ckpt = ["--ckpt-dir", str(tmp_path / "b")]
    first = train.main(argv + ckpt, on_step=stop_at_3)
    assert first["losses"] == straight["losses"][:3]
    assert "emergency=True" in capsys.readouterr().out
    resumed = train.main(argv + ckpt)
    assert "resumed from step 3" in capsys.readouterr().out
    assert resumed["start"] == 3 and resumed["state"]["step"] == 6
    assert resumed["losses"] == straight["losses"][3:]
    for key in ("params_trainable", "opt", "sel_idx"):
        a = tree_leaves(resumed["state"][key])
        b = tree_leaves(straight["state"][key])
        assert len(a) == len(b) and all(torch.equal(x, y)
                                        for x, y in zip(a, b))
