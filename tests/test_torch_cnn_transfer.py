"""The port's Table II transfer path (`repro_torch.launch.cnn_transfer`)
against the reference's `benchmarks/table2_evaluation.py`: data, selection,
a short transfer, learnability, the launch counts of the pruning kernel,
and the pruning / distillation helpers around it."""
import dataclasses
import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import mobilenetv2_cifar as JC  # noqa: E402
from repro.core import distill as jdistill  # noqa: E402
from repro.core import pruning as jpruning  # noqa: E402
from repro.data import synthetic as jdata  # noqa: E402
from repro.models import mobilenet_v2 as JM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import mobilenetv2_cifar as PC  # noqa: E402
from repro_torch.core import distill as pdistill  # noqa: E402
from repro_torch.core import pruning as ppruning  # noqa: E402
from repro_torch.core.sparse_update import tree_leaves  # noqa: E402
from repro_torch.data import synthetic as pdata  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import cnn_transfer as CT  # noqa: E402
from repro_torch.models import mobilenet_v2 as PM  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@functools.lru_cache(maxsize=None)
def _table2():
    """The reference's benchmarks/table2_evaluation.py, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        "table2_evaluation", ROOT / "benchmarks" / "table2_evaluation.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def _jinit(seed: int):
    """The reference's smoke init, jitted (eager it is several seconds)."""
    return jax.device_get(jax.jit(JM.init_params, static_argnums=0)(
        JC.smoke_config(), jax.random.PRNGKey(seed)))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("img,seed", [(32, 0), (20, 3)])
def test_transfer_batches_are_bitwise_the_reference(img, seed):
    jt, pt = jdata.TransferTask(img=img, seed=seed), \
        pdata.TransferTask(img=img, seed=seed)
    for domain in ("target", "pretrain"):
        for step in (0, 7, 10_001):
            a, b = jt.batch(9, step, domain), pt.batch(9, step, domain)
            assert a["images"].dtype == b["images"].dtype == np.float32
            assert a["images"].tobytes() == b["images"].tobytes()
            assert a["labels"].tobytes() == b["labels"].tobytes()
    js = jdata.transfer_image_batches(4, img, seed, "target", start_step=2)
    ps = pdata.transfer_image_batches(4, img, seed, "target", start_step=2)
    for _ in range(2):
        a, b = next(js), next(ps)
        assert a["images"].tobytes() == b["images"].tobytes()


# ---------------------------------------------------------------------------
# selection and the frozen / trainable split
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full_width"])
def test_magnitude_selection_matches_table2(full):
    """The magnitude selection's indices and specs equal the reference's
    `_selection` on the same weights (the reference's smoke init; at full
    width the port's init, numpy on both sides)."""
    if full:
        pcfg = dataclasses.replace(PC.CONFIG, img_size=32)
        jcfg = dataclasses.replace(JC.CONFIG, img_size=32)
        jp = bridge.to_numpy(PM.init_params(pcfg,
                                            torch.Generator().manual_seed(2)))
    else:
        pcfg, jcfg, jp = PC.smoke_config(), JC.smoke_config(), _jinit(0)
    jidx, jspec = _table2()._selection(jcfg, jax.tree.map(jnp.asarray, jp),
                                       0.2, 6, jax.random.PRNGKey(7))
    pidx, pspec = CT._selection(pcfg, bridge.to_torch(jp), 0.2, 6)
    assert list(pidx) == list(jidx)
    for name in jidx:
        assert tuple(pspec[name]) == tuple(jspec[name])
        assert pidx[name].dtype == torch.int32
        np.testing.assert_array_equal(pidx[name].numpy(),
                                      np.asarray(jidx[name]))


def test_random_selection_properties():
    """The dynamic phase's draws: n_sel distinct in-range blocks per conv, a
    pure function of (seed, step, name), and a new draw each step."""
    cfg = PC.smoke_config()
    params = bridge.to_torch(_jinit(0))
    draws = [CT._selection(cfg, params, 0.2, 6, seed=0, step=s,
                           magnitude=False) for s in range(6)]
    for idx, spec in draws:
        for name, sel in idx.items():
            v = sel[0].tolist()
            assert tuple(sel.shape) == (1, spec[name].n_sel)
            assert len(set(v)) == len(v)
            assert all(0 <= i < spec[name].n_blocks for i in v)
    again, _ = CT._selection(cfg, params, 0.2, 6, seed=0, step=3,
                             magnitude=False)
    assert all(torch.equal(again[n], draws[3][0][n]) for n in again)
    changed = sum(not torch.equal(draws[s][0][n], draws[s + 1][0][n])
                  for s in range(5) for n in again
                  if draws[0][1][n].n_sel < draws[0][1][n].n_blocks)
    assert changed > 0


def test_split_trains_whole_blocks_as_the_reference_code_does():
    """fixed / dynamic train the classifier and the whole blocks of the last
    6 convs, GroupNorm included (the reference's code; its comment says GN
    frozen, see ROADMAP queue C)."""
    cfg = PC.CONFIG
    params = {k: {"w": k} for k in ["stem", "head", "classifier"]
              + [f"b{i}" for i in range(17)]}
    frozen, trainable = CT.split_for(cfg, params, "dynamic")
    assert set(trainable) == {"b15", "b16", "head", "classifier"}
    assert set(frozen) | set(trainable) == set(params)
    assert CT.split_for(cfg, params, "full") == (None, params)
    assert set(CT.split_for(cfg, params, "last")[1]) == {"classifier"}


@pytest.mark.parametrize("method,want", [("dynamic", (35, 5)),
                                         ("fixed", (35, 5)),
                                         ("full", (35, 35)),
                                         ("last", (35, 0)),
                                         ("none", (0, 0))])
def test_prune_launches_at_full_width(method, want):
    """The per-step launch counts chip_smoke.py asserts on the card."""
    assert CT.prune_launches(PC.CONFIG, method) == want


@pytest.mark.parametrize("method", ["fixed", "full", "last"])
def test_prune_launches_match_a_step(method, monkeypatch):
    """prune_launches against the pruning entry points one smoke training
    step really calls (counted on the CPU by wrapping them)."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = ops.block_act_prune_fwd, ops.block_act_prune_bwd

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(ops, "block_act_prune_fwd", count("fwd", fwd))
    monkeypatch.setattr(ops, "block_act_prune_bwd", count("bwd", bwd))
    cfg = PC.smoke_config()
    task = pdata.TransferTask(img=cfg.img_size)
    CT._transfer(cfg, task, bridge.to_torch(_jinit(0)), method, steps=1,
                 batch=2, phase_j=1, phase_k=0, seed=0, device="cpu")
    assert (calls["fwd"], calls["bwd"]) == CT.prune_launches(cfg, method)


# ---------------------------------------------------------------------------
# transfer
# ---------------------------------------------------------------------------

def _near_threshold(cfg, params, batch, thr=0.15, blk=2, margin=1e-5):
    """Blocks of the port's training forward whose max |x| lies within
    `margin` (relative) of the threshold: the ones a one-ulp difference
    between the frameworks could flip."""
    n = [0]

    def probe(v):
        m = v.reshape(v.shape[:-1] + (v.shape[-1] // blk, blk)).abs() \
            .amax(-1)
        n[0] += int(((m - thr).abs() <= margin * thr).sum())
        return v
    with torch.no_grad():
        PM.forward(cfg, (None, params), torch.from_numpy(batch["images"]),
                   act_prune=lambda v: CT.make_act_pruner(thr, blk)(probe(v)))
    return n[0]

def test_fixed_transfer_3_steps_matches_table2(monkeypatch):
    """3 steps of the `fixed` method from the reference's init on the same
    batches: the reference's own `_transfer` (STEPS = 3, BATCH = 16, its
    final params taken where it evaluates them) against the port's.
    Trainable leaves to 1e-5 of each leaf's largest entry (fp32 convs summed
    in another order, 3 momentum steps); frozen leaves bitwise; the
    evaluated accuracy and the extra-memory figure equal.

    Batch 16 because at the reference's 32 one block of the second step's
    activations has its max within 1e-5 of the threshold: it flips between
    the frameworks and moves that step's gradients by 5e-3. The port's
    forward is probed before every step, and a block that close fails the
    test as a flip, not as a tolerance."""
    t2 = _table2()
    jcfg, pcfg = JC.smoke_config(), PC.smoke_config()
    jpre = _jinit(0)
    seen = {}
    real_eval = t2._eval

    def capture(cfg, task, p, n=t2.EVAL_BATCHES):
        seen["params"] = jax.device_get(p)
        return real_eval(cfg, task, p, n)
    monkeypatch.setattr(t2, "STEPS", 3)
    monkeypatch.setattr(t2, "BATCH", 16)
    monkeypatch.setattr(t2, "_eval", capture)
    jacc, jextra = t2._transfer(jcfg, jdata.TransferTask(img=32, seed=0),
                                jax.tree.map(jnp.asarray, jpre), "fixed")
    task = pdata.TransferTask(img=32, seed=0)
    pre = bridge.to_torch(jpre)
    near = [_near_threshold(pcfg, pre, task.batch(16, 0, "target"))]

    def probe(step, state, metrics):
        if step < 3:
            near.append(_near_threshold(
                pcfg, {**state["frozen"], **state["trainable"]},
                task.batch(16, step, "target")))
    row = CT._transfer(pcfg, task, pre, "fixed", steps=3, batch=16,
                       phase_j=30, phase_k=60, seed=0, device="cpu",
                       on_step=probe)
    assert near == [0, 0, 0]
    assert len(row["losses"]) == 3 and all(np.isfinite(row["losses"]))
    assert row["extra_mem"] == jextra
    assert row["acc"] == pytest.approx(jacc, abs=1e-6)
    got, want = bridge.to_numpy(row["params"]), seen["params"]
    trainable = set(CT.split_for(pcfg, want, "fixed")[1])
    moved = 0
    for key in want:
        for g, w, w0 in zip(jax.tree.leaves(got[key]),
                            jax.tree.leaves(want[key]),
                            jax.tree.leaves(jpre[key])):
            if key in trainable:
                scale = max(float(np.abs(w).max()), 1e-30)
                assert float(np.abs(g - w).max()) <= 1e-5 * scale
                moved += int(not np.array_equal(g, w0))
            else:
                assert g.tobytes() == w.tobytes() == np.asarray(w0).tobytes()
    assert moved > 0


def test_fixed_phase_leaves_unselected_blocks_bitwise():
    """In the first fixed phase (momentum starting at zero) the unselected
    output-channel blocks of the selected 1x1 convs keep their pretrained
    values bitwise, and the selected ones move; the dynamic phase draws a
    new selection each step and the late fixed phase keeps the last."""
    cfg = PC.smoke_config()
    pre = bridge.to_torch(_jinit(0))
    seen = []

    def on_step(step, state, metrics):
        seen.append((step, {k: v.clone() for k, v in state["idx"].items()}))
        if step > 2:
            return
        for name, sp in state["spec"].items():
            path = name.split("/")[:-1]
            w0, w = pre, state["trainable"]
            for part in path:
                w0, w = w0[part], w[part]
            w0, w = w0["w"], w["w"]
            if w0.shape[2] == 1:     # depthwise: selected by layer only
                continue
            mask = torch.zeros(sp.n_blocks, dtype=torch.bool)
            mask[state["idx"][name][0].long()] = True
            wb, w0b = (a.reshape(-1, sp.n_blocks, sp.block) for a in (w, w0))
            assert torch.equal(wb[:, ~mask], w0b[:, ~mask]), (step, name)
            assert not torch.equal(wb[:, mask], w0b[:, mask]), (step, name)
    CT._transfer(cfg, pdata.TransferTask(img=32), pre, "dynamic", steps=5,
                 batch=4, phase_j=2, phase_k=2, seed=0, device="cpu",
                 on_step=on_step)
    idx = [s[1] for s in seen]
    same = lambda a, b: all(torch.equal(a[n], b[n]) for n in a)  # noqa: E731
    assert same(idx[0], idx[1])            # fixed: the magnitude selection
    assert not same(idx[1], idx[2]) and not same(idx[2], idx[3])
    assert same(idx[3], idx[4])            # late fixed keeps the last draw


def test_full_fine_tuning_learns():
    """30 steps of full fine-tuning (momentum 0.9, lr 0.05, no pruning) from
    the reference's init, as tests/test_system.py::test_cnn_transfer_learns
    runs the reference: accuracy on 4 x 64 target images rises by at least
    0.05. The reference itself goes 0.152 -> 0.258 here, short of the +0.2
    that test asks for (ROADMAP queue C)."""
    cfg = PC.smoke_config()
    task = pdata.TransferTask(img=cfg.img_size, seed=0)
    acc0, acc_full = CT.learnability(cfg, task, bridge.to_torch(_jinit(0)),
                                     "cpu")
    print(f"acc0={acc0:.4f} acc_full={acc_full:.4f}")
    assert acc_full >= acc0 + 0.05, (acc0, acc_full)


def test_cli_on_the_cpu(capsys):
    out = CT.main(["--device", "cpu", "--steps", "3", "--pretrain-steps", "2",
                   "--batch", "4", "--methods", "none,last,dynamic",
                   "--phase-j", "1", "--phase-k", "1"])
    rows = out["rows"]
    assert [r["method"] for r in rows] == ["none", "last", "dynamic"]
    n_tr = sum(x.numel() for x in tree_leaves(
        CT.split_for(out["cfg"], out["pretrained"], "dynamic")[1]))
    assert rows[2]["extra_mem"] == int(n_tr * 0.2 * 4 * 2)
    assert all(0.0 <= r["acc"] <= 1.0 for r in rows)
    assert all(np.isfinite(r["losses"]).all() for r in rows)
    text = capsys.readouterr().out
    assert "cudnn.allow_tf32=False" in text
    assert text.count("table2/") == 3
    with pytest.raises(SystemExit):
        CT.main(["--device", "cpu", "--methods", "none,bogus"])


# ---------------------------------------------------------------------------
# pruning and distillation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pattern,rate", [(False, 0.0), (True, 0.6)])
def test_full_prune_matches_reference(pattern, rate):
    """Masks, pruned weights and the report, bitwise (a mask is a product
    by 0 or 1), from the reference's init."""
    jcfg, pcfg = JC.smoke_config(), PC.smoke_config()
    jp = _jinit(0)
    jpruned, jrep = jpruning.full_prune(jax.tree.map(jnp.asarray, jp), jcfg,
                                        channel_target=0.45, pattern=pattern,
                                        unstructured_rate=rate)
    ppruned, prep = ppruning.full_prune(bridge.to_torch(jp), pcfg,
                                        channel_target=0.45, pattern=pattern,
                                        unstructured_rate=rate)
    assert prep == jrep
    want, got = jax.device_get(jpruned), bridge.to_numpy(ppruned)
    assert jax.tree.structure(want) == jax.tree.structure(got)
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        assert np.asarray(a).tobytes() == b.tobytes()
    jm = jpruning.channel_prune_masks(jax.tree.map(jnp.asarray, jp), jcfg,
                                      0.45)
    pm = ppruning.channel_prune_masks(bridge.to_torch(jp), pcfg, 0.45)
    assert all(np.array_equal(np.asarray(jm[k]), pm[k].numpy()) for k in jm)


def test_conv_flops_matches_reference():
    for jcfg, pcfg in ((JC.smoke_config(), PC.smoke_config()),
                       (JC.CONFIG, PC.CONFIG)):
        for img in (32, 224):
            assert ppruning.conv_flops(pcfg, img) == \
                jpruning.conv_flops(jcfg, img)


@pytest.mark.parametrize("temperature,alpha", [(4.0, 0.5), (1.0, 0.9)])
def test_distillation_losses_match_reference(temperature, alpha):
    """kd_loss and combined_kd_loss in fp32: 1e-6 relative (softmax and
    log in another order)."""
    rng = np.random.default_rng(int(temperature * 10))
    s = rng.normal(size=(8, 10)).astype(np.float32) * 3
    t = rng.normal(size=(8, 10)).astype(np.float32) * 3
    y = rng.integers(0, 10, 8).astype(np.int32)
    jkd = float(jdistill.kd_loss(jnp.asarray(s), jnp.asarray(t), temperature))
    pkd = float(pdistill.kd_loss(torch.from_numpy(s), torch.from_numpy(t),
                                 temperature))
    assert pkd == pytest.approx(jkd, rel=1e-6)
    jc = float(jdistill.combined_kd_loss(jnp.asarray(s), jnp.asarray(t),
                                         jnp.asarray(y), alpha, temperature))
    pc = float(pdistill.combined_kd_loss(torch.from_numpy(s),
                                         torch.from_numpy(t),
                                         torch.from_numpy(y), alpha,
                                         temperature))
    assert pc == pytest.approx(jc, rel=1e-6)
