"""The port's checkpointing and fault-tolerance runtime against the
reference's: the msgpack codec byte for byte against `msgpack.packb`,
pytree round trips, the file format both ways between the packages (zstd
and the `ZLB0` zlib frame), retention, corruption and the fall-back
restore, chaos `torn` writes, a reference-written train state trained on
in the port, the compact-state and delta-store round trips, the runtime
copies (`PreemptionHandler`, `StragglerMonitor`, `RestartableLoop`), the
launcher's resume past a torn file, and all of it without `msgpack` or
`zstandard` installed."""
import os
import signal
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
msgpack = pytest.importorskip("msgpack")
import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.checkpoint import manager as JM  # noqa: E402
from repro.core.delta import DeltaState as JDeltaState  # noqa: E402
from repro.serve.deltas import DeltaStore as JDeltaStore  # noqa: E402
from repro.train import make_train_state as jstate  # noqa: E402
from repro.train import make_train_step as jstep  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as PC  # noqa: E402
from repro_torch.checkpoint import manager as PM  # noqa: E402
from repro_torch.checkpoint import msgpack as pmsg  # noqa: E402
from repro_torch.core.delta import DeltaState  # noqa: E402
from repro_torch.core.sparse_update import tree_leaves, tree_map  # noqa: E402
from repro_torch.runtime import (FaultSchedule, PreemptionHandler,  # noqa: E402
                                 RestartableLoop, StragglerMonitor)
from repro_torch.serve.deltas import DeltaStore  # noqa: E402
from repro_torch.train import make_train_state, make_train_step  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

OBJECTS = [
    None, True, False, 0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1,
    2**32, 2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2**31,
    -2**31 - 1, -2**63, 0.0, 1.5, -2.25e300, "", "a", "x" * 31, "y" * 32,
    "z" * 255, "w" * 256, "ü" * 40, "v" * 70000, b"", b"\x00" * 255,
    b"\x01" * 256, b"\x02" * 65536, [], list(range(15)), list(range(16)),
    list(range(70000)), (1, "a"), {}, {str(i): i for i in range(15)},
    {str(i): i for i in range(16)}, {str(i): None for i in range(70000)},
    {"__meta__": {"step": 7, "time": 1.7e9, "users": [1, "u"]},
     "a/b": {"d": "bfloat16", "s": [2, 3], "b": b"\x00" * 12}},
]


@pytest.mark.parametrize("i", range(len(OBJECTS)))
def test_msgpack_codec_is_byte_for_byte_msgpack(i):
    obj = OBJECTS[i]
    want = msgpack.packb(obj, use_bin_type=True)
    assert pmsg.packb(obj) == want
    back = pmsg.unpackb(want)
    ref = msgpack.unpackb(want, raw=False, strict_map_key=False)
    assert back == ref


def test_msgpack_refuses_what_it_cannot_encode():
    with pytest.raises(TypeError):
        pmsg.packb({1.5j})
    with pytest.raises(ValueError):
        pmsg.packb(2**64)
    with pytest.raises(ValueError, match="msgpack bin"):
        PM._record_head("w", "bfloat16", (2**31,), 2**32)


def _tree(rng, dtype):
    t = torch.from_numpy((rng.standard_normal((3, 4)) * 10).astype(
        np.float32)).to(dtype)
    return {"a": {"b": t, "c": torch.arange(3, dtype=torch.int32)},
            "d": t.t().contiguous(), "e": torch.tensor(7, dtype=torch.int32),
            "f": [torch.zeros(0), torch.ones(2, dtype=torch.bool)],
            "g": None, "h": {}}


@pytest.mark.parametrize("codec", ["zstd", "zlib"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
def test_pytree_round_trip(tmp_path, monkeypatch, dtype, codec):
    if codec == "zlib":
        monkeypatch.setattr(PM, "zstandard", None)
    tree = _tree(np.random.default_rng(0), dtype)
    path = str(tmp_path / "x.ckpt")
    PM.save_pytree(path, tree, {"k": 1})
    head = open(path, "rb").read(4)
    assert (head == b"ZLB0") == (codec == "zlib")
    loaded, meta = PM.load_pytree(path, target=tree)
    assert meta == {"k": 1}
    assert loaded["g"] is None and loaded["h"] == {}
    want, got = PM._flatten(tree), PM._flatten(loaded)
    assert list(want) == list(got)
    for a, b in zip(want.values(), got.values()):
        assert a.dtype == b.dtype and torch.equal(a, b)
    flat, _ = PM.load_pytree(path)
    assert torch.equal(flat["a"]["b"], tree["a"]["b"])
    assert torch.equal(flat["f"]["1"], tree["f"][1])


@pytest.mark.parametrize("codec", ["zstd", "zlib"])
def test_port_files_read_in_the_reference(tmp_path, monkeypatch, codec):
    if codec == "zlib":
        monkeypatch.setattr(PM, "zstandard", None)
    tree = _tree(np.random.default_rng(1), torch.bfloat16)
    path = str(tmp_path / "x.ckpt")
    PM.save_pytree(path, tree, {"step": 3})
    arrays, meta = JM.load_pytree(path)
    assert meta == {"step": 3}
    want = bridge.to_numpy(tree["a"]["b"])
    assert arrays["a"]["b"].dtype == want.dtype
    np.testing.assert_array_equal(arrays["a"]["b"].view(np.uint16),
                                  want.view(np.uint16))
    np.testing.assert_array_equal(arrays["e"], 7)
    np.testing.assert_array_equal(arrays["f"]["1"], [True, True])


def test_the_same_tree_gives_the_references_bytes(tmp_path, monkeypatch):
    """Leaf order, keys, records and meta as the reference writes them:
    zlib at the same level gives the same file byte for byte."""
    monkeypatch.setattr(PM, "zstandard", None)
    monkeypatch.setattr(JM, "zstandard", None)
    monkeypatch.setattr(PM, "ZLIB_LEVEL", 6)
    tree = {"w": np.arange(12, dtype=np.float32).reshape(3, 4),
            "b": {"z": np.ones(2, np.int32), "a": np.zeros((), np.int32)}}
    PM.save_pytree(str(tmp_path / "p.ckpt"), bridge.to_torch(tree),
                   {"step": 1})
    JM.save_pytree(str(tmp_path / "j.ckpt"), tree, {"step": 1})
    assert (tmp_path / "p.ckpt").read_bytes() == \
        (tmp_path / "j.ckpt").read_bytes()


@pytest.mark.parametrize("codec", ["zstd", "zlib"])
def test_reference_files_read_in_the_port(tmp_path, monkeypatch, codec):
    if codec == "zlib":
        monkeypatch.setattr(JM, "zstandard", None)
    tree = {"w": jnp.linspace(-3, 3, 12, dtype=jnp.bfloat16).reshape(3, 4),
            "i": jnp.arange(5), "k": jax.random.PRNGKey(0)}
    path = str(tmp_path / "j.ckpt")
    JM.save_pytree(path, tree, {"m": [1, 2]})
    got, meta = PM.load_pytree(path)
    assert meta == {"m": [1, 2]}
    assert got["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(bridge.to_numpy(got["w"]).view(np.uint16),
                                  np.asarray(tree["w"]).view(np.uint16))
    np.testing.assert_array_equal(got["i"].numpy(), np.arange(5))
    assert got["k"].dtype == torch.uint32


def test_manager_retention_latest_and_shape_mismatch(tmp_path):
    mgr = PM.CheckpointManager(str(tmp_path), keep=2)
    tree = {"x": torch.ones(3)}
    assert mgr.latest_step() is None and mgr.restore() == (None, None)
    for step in (10, 20, 30, 40):
        mgr.save(step, tree)
    assert mgr.all_steps() == [30, 40] and mgr.latest_step() == 40
    assert sorted(os.listdir(tmp_path)) == ["step_000000030.ckpt",
                                            "step_000000040.ckpt"]
    _, meta = mgr.restore(target=tree)
    assert meta["step"] == 40
    _, meta = mgr.restore(30, target=tree)
    assert meta["step"] == 30
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore(target={"x": torch.ones(4)})
    with pytest.raises(KeyError, match="missing leaf"):
        mgr.restore(target={"x": torch.ones(3), "y": torch.ones(1)})


@pytest.mark.parametrize("codec", ["zstd", "zlib"])
def test_bit_flip_and_torn_files_raise_and_restore_falls_back(
        tmp_path, monkeypatch, codec):
    if codec == "zlib":
        monkeypatch.setattr(PM, "zstandard", None)
    path = str(tmp_path / "x.ckpt")
    PM.save_pytree(path, {"w": torch.arange(64.0)})
    blob = bytearray(open(path, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    open(path, "wb").write(bytes(blob))
    with pytest.raises(PM.CheckpointCorruptError, match="checksum"):
        PM.load_pytree(path)
    open(path, "wb").write(b"")
    with pytest.raises(PM.CheckpointCorruptError, match="empty"):
        PM.load_pytree(path)

    mgr = PM.CheckpointManager(str(tmp_path / "m"))
    tree = {"x": torch.ones(3)}
    mgr.save(1, tree, {"tag": "old"})
    mgr.save(2, tree, {"tag": "new"})
    p2 = mgr._path(2)
    blob = open(p2, "rb").read()
    open(p2, "wb").write(blob[:len(blob) // 2])        # torn: no footer
    with pytest.raises(PM.CheckpointCorruptError, match="corrupt"):
        PM.load_pytree(p2)
    with pytest.warns(UserWarning, match="falling back"):
        loaded, meta = mgr.restore(target=tree)
    assert meta["step"] == 1 and meta["tag"] == "old"
    assert torch.equal(loaded["x"], torch.ones(3))
    p1 = mgr._path(1)
    open(p1, "wb").write(open(p1, "rb").read()[:10])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(PM.CheckpointCorruptError, match="no intact"):
            mgr.restore(target=tree)


def test_chaos_torn_write_injection(tmp_path):
    mgr = PM.CheckpointManager(str(tmp_path),
                               chaos=FaultSchedule(0, rates={"torn": 1.0}))
    tree = {"x": torch.full((2,), 5.0)}
    PM.CheckpointManager(str(tmp_path)).save(1, tree)
    mgr.save(2, tree)
    assert mgr.torn_writes == 1 and mgr.chaos.faults_by_kind == {"torn": 1}
    assert os.path.getsize(mgr._path(2)) < os.path.getsize(mgr._path(1))
    assert not [f for f in os.listdir(tmp_path) if "chaos" in f]
    with pytest.warns(UserWarning, match="falling back"):
        _, meta = mgr.restore(target=tree)
    assert meta["step"] == 1
    # the same seed tears the same draws
    a = FaultSchedule(5, rates={"torn": 0.5})
    b = FaultSchedule(5, rates={"torn": 0.5})
    assert [a.draw("torn") for _ in range(20)] == \
        [b.draw("torn") for _ in range(20)]


def _tcs(kind="momentum"):
    opt = {"momentum": 0.9} if kind == "momentum" else {}
    return [C.TrainConfig(
        model=C.get_smoke_config("llama3-8b"),
        shape=C.ShapeConfig("t", 16, 4, "train"),
        sparse=C.SparseUpdateConfig(update_ratio=0.5, num_update_layers=2,
                                    channel_block=8),
        optimizer=C.OptimizerConfig(kind=kind, learning_rate=0.05, **opt))
        for C in (JC, PC)]


def _batches(n, seed=7):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, 256, (4, 16)).astype(np.int32),
             "labels": rng.integers(0, 256, (4, 16)).astype(np.int32)}
            for _ in range(n)]


def test_reference_train_state_restores_into_the_port_and_trains_on(
        tmp_path):
    """The reference trains 2 compact momentum steps and saves (its jax
    `rng` key included); the port restores that file onto its own state
    and both train 2 more fixed-phase steps: the same losses (1e-5), and
    the port's step count and selection carried over."""
    jtc, ptc = _tcs()
    js, jplan = jstate(jtc, jax.random.PRNGKey(0))
    jfn = jax.jit(jstep(jtc, jplan, compact_grads=True))
    batches = _batches(4)
    for b in batches[:2]:
        js, _ = jfn(js, {k: jnp.asarray(v) for k, v in b.items()})
    JM.CheckpointManager(str(tmp_path)).save(2, js)
    target, pplan = make_train_state(ptc, device="cpu")
    tree, meta = PM.CheckpointManager(str(tmp_path)).restore(
        target=bridge.state_to_tree(target))
    ps = bridge.state_from_tree(tree, seed=ptc.seed)
    assert meta["step"] == 2 and ps["step"] == 2 and "rng" not in tree
    pfn = make_train_step(ptc, pplan, compact_grads=True)
    for b in batches[2:]:
        js, jm = jfn(js, {k: jnp.asarray(v) for k, v in b.items()})
        ps, pm = pfn(ps, {k: torch.from_numpy(v) for k, v in b.items()})
        assert float(pm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  abs=1e-5)
    got = bridge.state_to_numpy(ps)
    js = jax.device_get(js)
    assert int(got["step"]) == int(js["step"]) == 4
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree.leaves(got["sel_idx"]), jax.tree.leaves(js["sel_idx"])))


@pytest.mark.parametrize("kind", ["sgd", "momentum", "adamw"])
def test_compact_state_round_trip_is_bitwise(tmp_path, kind):
    """save -> restore -> continue is bit-identical to an uninterrupted
    run (the reference's test_compact_state_checkpoint_roundtrip)."""
    _, ptc = _tcs(kind)
    state, plan = make_train_state(ptc, device="cpu")
    step = make_train_step(ptc, plan, compact_grads=True)
    b1, b2 = [{k: torch.from_numpy(v) for k, v in b.items()}
              for b in _batches(2)]
    s, _ = step(state, b1)
    mgr = PM.CheckpointManager(str(tmp_path), keep=2)
    mgr.save(1, bridge.state_to_tree(s))
    tree, meta = mgr.restore(1, target=bridge.state_to_tree(s))
    restored = bridge.state_from_tree(tree, seed=s["rng"])
    assert meta["step"] == 1 and restored["step"] == 1
    s_cont, m1 = step(s, b2)          # the compact step writes s in place
    s_res, m2 = step(restored, b2)
    assert float(m1["loss"]) == float(m2["loss"])
    for key in ("params_trainable", "opt", "sel_idx"):
        a, b = tree_leaves(s_cont[key]), tree_leaves(s_res[key])
        assert len(a) == len(b) and all(torch.equal(x, y)
                                        for x, y in zip(a, b))


def _port_entry(user):
    g = torch.Generator().manual_seed(int(user))
    return DeltaState(
        idx={"blocks": {"attn": {"wq": torch.randint(
            0, 4, (2, 2, 2), generator=g, dtype=torch.int32)}}},
        vals={"blocks": {"attn": {"wq": torch.randn(
            (2, 16, 2, 2, 8), generator=g)}}})


def _filled(store_cls, make):
    store = store_cls(4, make)
    for u in (1, 2, 3):
        store.admit(u)
        store.release(u)
    store.get(1)                       # LRU order now [2, 3, 1]
    return store


def test_delta_store_round_trips_both_ways(tmp_path):
    """Port -> port, port -> reference and reference -> port: users in LRU
    order, entries unpinned, every leaf equal."""
    store = _filled(DeltaStore, _port_entry)
    path = str(tmp_path / "p.ckpt")
    PM.save_delta_store(path, store, meta={"tag": "t"})
    back = DeltaStore(4, _port_entry)
    assert PM.restore_delta_store(path, back)["tag"] == "t"
    assert back.users() == store.users() == [2, 3, 1]
    for u in (1, 2, 3):
        assert back.ref(u) == 0
        for x, y in zip(tree_leaves(store.peek(u).to_tree()),
                        tree_leaves(back.peek(u).to_tree())):
            assert x.dtype == y.dtype and torch.equal(x, y)
    back.check()

    jstore = JDeltaStore(4, lambda u: None)
    JM.restore_delta_store(path, jstore)
    assert jstore.users() == [2, 3, 1]
    for u in (1, 2, 3):
        for x, y in zip(tree_leaves(store.peek(u).to_tree()),
                        jax.tree.leaves(jstore.peek(u).to_tree())):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))

    def jentry(user):
        e = _port_entry(user)
        return JDeltaState(idx=bridge.to_numpy(e.idx),
                           vals=bridge.to_numpy(e.vals))
    jpath = str(tmp_path / "j.ckpt")
    JM.save_delta_store(jpath, _filled(JDeltaStore, jentry))
    port = DeltaStore(4, _port_entry)
    PM.restore_delta_store(jpath, port)
    assert port.users() == [2, 3, 1]
    for u in (1, 2, 3):
        for x, y in zip(tree_leaves(store.peek(u).to_tree()),
                        tree_leaves(port.peek(u).to_tree())):
            assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# the runtime copies
# ---------------------------------------------------------------------------

def test_straggler_monitor_flags_slow_steps():
    mon = StragglerMonitor(factor=2.0, warmup_steps=3)
    for _ in range(10):
        mon.record(0.10)
    assert not mon.flagged
    assert mon.record(0.35) is True
    assert mon.flagged == [(11, 0.35)] and mon.median() == pytest.approx(0.1)


def test_preemption_makes_an_emergency_checkpoint(tmp_path):
    mgr = PM.CheckpointManager(str(tmp_path))
    state = {"x": torch.zeros(()), "step": torch.zeros((), dtype=torch.int32)}

    def step_fn(state, batch):
        if int(state["step"]) == 2:       # SIGTERM mid-training
            os.kill(os.getpid(), signal.SIGTERM)
        return ({"x": state["x"] + 1.0, "step": state["step"] + 1},
                {"loss": state["x"]})

    prev = signal.getsignal(signal.SIGTERM)
    result = RestartableLoop(mgr, state, total_steps=100,
                             checkpoint_every=50).run(step_fn,
                                                      iter([{}] * 100))
    assert signal.getsignal(signal.SIGTERM) == prev
    assert result["emergency"] is True and result["step"] == 3
    assert mgr.latest_step() == 3
    loaded, meta = mgr.restore(target=state)
    assert meta.get("emergency") is True and float(loaded["x"]) == 3.0
    with PreemptionHandler(include_sigint=True) as pre:
        assert not pre.preempted
        os.kill(os.getpid(), signal.SIGINT)
        assert pre.preempted


def test_restartable_loop_saves_once_a_step_and_resumes(tmp_path):
    saves = []

    class Counting(PM.CheckpointManager):
        def save(self, step, tree, meta=None):
            saves.append(int(step))
            super().save(step, tree, meta)

    mgr = Counting(str(tmp_path))
    state = {"x": torch.zeros(())}
    step_fn = lambda s, b: ({"x": s["x"] + 1.0}, {})
    RestartableLoop(mgr, state, total_steps=7, checkpoint_every=3).run(
        step_fn, iter([{}] * 7))
    assert saves == [3, 6, 7] and mgr.latest_step() == 7
    _, meta = mgr.restore(target=state)
    assert meta.get("final") is True
    loop = RestartableLoop(mgr, state, total_steps=7, checkpoint_every=3)
    assert loop.resume() == 7 and float(loop.state["x"]) == 7.0


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

ARGV = ["--arch", "llama3-8b", "--smoke", "--steps", "6", "--batch", "2",
        "--seq", "16", "--update-layers", "2", "--compact-grads",
        "--channel-block", "8", "--phase-j", "2", "--phase-k", "2",
        "--log-every", "1", "--device", "cpu", "--ckpt-every", "2"]


def test_cli_resume_falls_back_past_a_torn_latest_checkpoint(tmp_path,
                                                             capsys):
    """Saves at steps 2, 4, 6; step 6 torn: the same command again warns,
    resumes from step 4 and runs steps 5-6 bitwise as before."""
    from repro_torch.launch import train
    argv = ARGV + ["--ckpt-dir", str(tmp_path)]
    first = train.main(argv)
    assert sorted(os.listdir(tmp_path)) == [
        f"step_00000000{s}.ckpt" for s in (2, 4, 6)]
    p6 = tmp_path / "step_000000006.ckpt"
    p6.write_bytes(p6.read_bytes()[:1000])
    capsys.readouterr()
    with pytest.warns(UserWarning, match="step 6 is torn"):
        again = train.main(argv)
    assert "resumed from step 4" in capsys.readouterr().out
    assert again["losses"] == first["losses"][4:]
    for a, b in zip(tree_leaves(again["state"]["params_trainable"]),
                    tree_leaves(first["state"]["params_trainable"])):
        assert torch.equal(a, b)


def test_checkpointing_needs_neither_msgpack_nor_zstandard(tmp_path):
    """In a process where both imports fail: a pytree round trip, the
    launcher's resume (bitwise), and a `ZLB0` file the reference reads."""
    code = f"""
import sys
sys.modules["msgpack"] = None
sys.modules["zstandard"] = None
import torch
from repro_torch.checkpoint import manager as PM
from repro_torch.launch import train
assert PM.zstandard is None and PM.codec() == "zlib"
tree = {{"w": torch.arange(6.0).reshape(2, 3).to(torch.bfloat16)}}
PM.save_pytree({str(tmp_path / "t.ckpt")!r}, tree, {{"k": 1}})
back, meta = PM.load_pytree({str(tmp_path / "t.ckpt")!r}, target=tree)
assert meta == {{"k": 1}} and torch.equal(back["w"], tree["w"])
argv = {ARGV!r}
a = train.main(argv + ["--ckpt-dir", {str(tmp_path / "a")!r}])
import os
os.remove({str(tmp_path / "a" / "step_000000006.ckpt")!r})
b = train.main(argv + ["--ckpt-dir", {str(tmp_path / "a")!r}])
assert b["start"] == 4 and b["losses"] == a["losses"][4:], (a, b)
bad = [m for m in ("msgpack", "zstandard") if sys.modules.get(m)]
assert not bad, bad
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), \
        res.stdout[-2000:] + res.stderr[-2000:]
    assert (tmp_path / "t.ckpt").read_bytes()[:4] == b"ZLB0"
    arrays, meta = JM.load_pytree(str(tmp_path / "t.ckpt"))
    assert meta == {"k": 1}
    np.testing.assert_array_equal(np.asarray(arrays["w"], np.float32),
                                  np.arange(6.0).reshape(2, 3))
