"""The port's gemma3 family (5:1 local:global super-blocks plus a tail of
local layers) against the reference's, on the gemma3-4b smoke config (one
super-block) and on it with 8 layers (one super-block and a 2-layer tail):
the forward at seq 32 past the window of 16, the sliding window's reach,
the layout and the selection plan, 3 compact train steps with SGD,
momentum and AdamW against the reference's step, compact against
dense-scatter inside the port, the kernel wrappers a step calls, and the
CLI."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.core import selection as jsel  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import make_train_state as jstate  # noqa: E402
from repro.train import make_train_step as jstep  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as PC  # noqa: E402
from repro_torch.core import selection as psel  # noqa: E402
from repro_torch.core.sparse_update import tree_leaves, tree_map  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.train import make_train_state, make_train_step  # noqa: E402

ARCH = "gemma3-4b"
OPTS = {"sgd": {}, "momentum": {"momentum": 0.9}, "adamw": {}}
# (num_layers, K): the smoke config's one super-block, trainable; 8 layers
# = one super-block + a 2-layer tail, all 3 scan steps trainable
DEPTHS = [(6, 1), (8, 3)]
SEQ = 32                         # past the smoke window of 16
LEAVES = {"attn": {"wq", "wk", "wv", "wo"}, "mlp": {"w_up", "w_down"}}


def _cfgs(num_layers=6):
    return [dataclasses.replace(C.get_smoke_config(ARCH),
                                num_layers=num_layers) for C in (JC, PC)]


def _tcs(kind, num_layers=6, k=1):
    return [C.TrainConfig(
        model=cfg, shape=C.ShapeConfig("t", SEQ, 2, "train"),
        sparse=C.SparseUpdateConfig(update_ratio=0.5, num_update_layers=k,
                                    channel_block=8),
        optimizer=C.OptimizerConfig(kind=kind, learning_rate=0.05,
                                    **OPTS[kind]))
        for C, cfg in zip((JC, PC), _cfgs(num_layers))]


def _batch(seed=3, b=2, s=SEQ):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, 256, (b, s)).astype(np.int32),
            "labels": rng.integers(0, 256, (b, s)).astype(np.int32)}


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _max_diff(a, b):
    return max(float(np.abs(np.asarray(x, np.float32)
                            - np.asarray(y, np.float32)).max())
               for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))


def _as_tuples(spec_tree):
    return jax.tree.map(tuple, spec_tree,
                        is_leaf=lambda x: hasattr(x, "n_blocks"))


# ---------------------------------------------------------------------------
# layout, forward, window
# ---------------------------------------------------------------------------

def test_layout_matches_reference():
    """Super-blocks of 6 (5 local + 1 global) and a tail of dense layers:
    34 layers are 5 super-blocks + 4; the windows per layer."""
    for n, want in ((6, [("blocks", 1, "gemma_super", 6)]),
                    (8, [("blocks", 1, "gemma_super", 6),
                         ("tail", 2, "dense", 1)])):
        jcfg, pcfg = _cfgs(n)
        assert [tuple(s) for s in PT.segment_layout(pcfg)] == want == \
            [tuple(s) for s in JT.segment_layout(jcfg)]
    full = PC.get_config(ARCH)
    assert [tuple(s) for s in PT.segment_layout(full)] == [
        ("blocks", 5, "gemma_super", 6), ("tail", 4, "dense", 1)]
    assert [PT._window_for(full, "gemma_super", i) for i in range(6)] == \
        [1024] * 5 + [0]
    assert PT._window_for(full, "dense", 0) == 1024
    assert PT._window_for(PC.get_config("deepseek-moe-16b"), "dense", 0) == 0


def test_param_tree_matches_reference_layout():
    """Same keys, shapes, dtypes (smoke with 8 layers; full width on the
    meta device, tied embeddings: ~3.12 B parameters)."""
    jcfg, pcfg = _cfgs(8)
    cases = ((JT.init_params(jcfg, jax.random.PRNGKey(0)),
              PT.init_params(pcfg, 0, "cpu")),
             (jax.eval_shape(lambda: JT.init_params(JC.get_config(ARCH),
                                                    jax.random.PRNGKey(0))),
              PT.init_params(PC.get_config(ARCH), 0, "meta")))
    for want, port in cases:
        flat_p = jax.tree_util.tree_flatten_with_path(jax.tree.map(
            lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]), port,
            is_leaf=lambda t: isinstance(t, torch.Tensor)))
        flat_j = jax.tree_util.tree_flatten_with_path(
            jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), want))
        assert flat_p[1] == flat_j[1]
        assert [v for _, v in flat_p[0]] == [v for _, v in flat_j[0]]
    n = sum(t.numel() for t in tree_leaves(port))
    assert "lm_head" not in port and 3.1e9 < n < 3.15e9


@pytest.mark.parametrize("num_layers", [6, 8])
def test_forward_matches_reference(num_layers):
    """f32, seq 32 (twice the window): the hidden states and the loss."""
    jcfg, pcfg = _cfgs(num_layers)
    params = JT.init_params(jcfg, jax.random.PRNGKey(num_layers))
    batch = _batch(seed=num_layers)
    want, _ = JT.forward(jcfg, (params, None),
                         {"tokens": jnp.asarray(batch["tokens"])})
    pp = bridge.to_torch(jax.device_get(params))
    got, aux = PT.forward(pcfg, (pp, None),
                          {"tokens": torch.from_numpy(batch["tokens"])})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert not aux.any()
    jl, _ = JT.loss_fn(jcfg, (params, None),
                       {k: jnp.asarray(v) for k, v in batch.items()})
    pl, _ = PT.loss_fn(pcfg, (pp, None), _tbatch(batch))
    assert float(pl) == pytest.approx(float(jl), abs=1e-5)


def test_sliding_window_restricts_reach():
    """The reference's test on the port's attention (a key beyond the
    window does not reach the output; the same numbers as the reference's
    `_sdpa_dense`), then at the block level: perturbing token 0 moves a
    local layer's output at positions < 16 only, the global layer's
    everywhere."""
    key = jax.random.PRNGKey(0)
    b, s, h, d = 1, 64, 2, 8
    q = jax.random.normal(key, (b, s, h, d))
    k = jax.random.normal(jax.random.PRNGKey(1), (b, s, h, d))
    v = jax.random.normal(jax.random.PRNGKey(2), (b, s, h, d))
    t = lambda a: torch.from_numpy(np.array(a))
    out1 = PL._sdpa_dense(t(q), t(k), t(v), window=8)
    k2, v2 = k.at[:, 0].set(100.0), v.at[:, 0].set(-100.0)
    out2 = PL._sdpa_dense(t(q), t(k2), t(v2), window=8)
    np.testing.assert_allclose(out1[:, 8:].numpy(), out2[:, 8:].numpy(),
                               rtol=1e-5, atol=1e-5)
    assert float((out1[:, 0] - out2[:, 0]).abs().max()) > 1.0
    np.testing.assert_allclose(
        out1.numpy(), np.asarray(JL._sdpa_dense(q, k, v, window=8)),
        rtol=1e-5, atol=1e-5)

    jcfg, pcfg = _cfgs(6)
    params = bridge.to_torch(jax.device_get(
        JT.init_params(jcfg, jax.random.PRNGKey(1))))
    block = tree_map(lambda a: a[0], params["segments"]["blocks"])
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, SEQ, pcfg.d_model)).astype(np.float32))
    x2 = x.clone()
    x2[:, 0] += 3.0
    pos = torch.arange(SEQ)[None]
    w = pcfg.sliding_window
    for i, local in ((0, True), (5, False)):
        win = PT._window_for(pcfg, "gemma_super", i)
        y1, _ = PT._apply_dense_block(pcfg, block[f"sub{i}"], x, pos, None,
                                      win)
        y2, _ = PT._apply_dense_block(pcfg, block[f"sub{i}"], x2, pos, None,
                                      win)
        moved = (y1 - y2).abs().amax(dim=(0, 2))
        assert bool((moved[1:w] > 0).all())
        assert bool((moved[w:] == 0).all()) == local, i


# ---------------------------------------------------------------------------
# plan and train steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["smoke", "smoke8", "full"])
@pytest.mark.parametrize("kw", [
    dict(update_ratio=0.2, num_update_layers=5, channel_block=128),
    dict(update_ratio=0.5, num_update_layers=3, channel_block=8),
])
def test_plan_matches_reference(which, kw):
    """seg_trainable and the SelSpec tree equal the reference's; K counts
    scan steps from the end, so on the full config K = 5 takes the 4-layer
    tail and the last super-block."""
    if which == "full":
        jcfg, pcfg = JC.get_config(ARCH), PC.get_config(ARCH)
    else:
        jcfg, pcfg = _cfgs(6 if which == "smoke" else 8)
    jplan = jsel.build_plan(jcfg, JC.SparseUpdateConfig(**kw), 4096)
    pplan = psel.build_plan(pcfg, PC.SparseUpdateConfig(**kw), 4096)
    assert pplan.seg_trainable == jplan.seg_trainable
    assert _as_tuples(pplan.spec) == _as_tuples(jplan.spec)
    assert {g: set(v) for g, v in pplan.spec["blocks"]["sub5"].items()} == \
        LEAVES
    if which == "full" and kw["num_update_layers"] == 5:
        assert pplan.seg_trainable == {"tail": 4, "blocks": 1}


@pytest.mark.parametrize("num_layers,k", DEPTHS, ids=["smoke", "smoke8"])
@pytest.mark.parametrize("kind,tol", [
    ("sgd", 1e-5),
    ("momentum", 1e-5),
    # the reference's own bound for AdamW (test_compact_path)
    ("adamw", 1e-2),
])
def test_compact_steps_match_reference(kind, tol, num_layers, k):
    """3 compact fixed-phase steps: losses (1e-5), trainable params (the
    norms by the dense rule too), selection, frozen params and optimizer
    state against the reference's jitted compact step, f32."""
    jtc, ptc = _tcs(kind, num_layers, k)
    js, jplan = jstate(jtc, jax.random.PRNGKey(0))
    pplan = psel.build_plan(ptc.model, ptc.sparse, 64)
    ps = bridge.state_to_torch(jax.device_get(js))
    jfn = jax.jit(jstep(jtc, jplan, compact_grads=True))
    pfn = make_train_step(ptc, pplan, compact_grads=True)
    batch = _batch()
    jb = {key: jnp.asarray(v) for key, v in batch.items()}
    for _ in range(3):
        js, jm = jfn(js, jb)
        ps, pm = pfn(ps, _tbatch(batch))
        assert float(pm["loss"]) == pytest.approx(float(jm["loss"]), abs=1e-5)
    got = bridge.state_to_numpy(ps)
    js = jax.device_get(js)
    for key in ("sel_idx", "params_frozen"):
        assert _max_diff(got[key], js[key]) == 0
    assert jax.tree.structure(got["params_trainable"]) == \
        jax.tree.structure(js["params_trainable"])
    assert _max_diff(got["params_trainable"], js["params_trainable"]) <= tol
    assert jax.tree.structure(got["opt"]) == jax.tree.structure(js["opt"])
    if js["opt"]:
        assert _max_diff(got["opt"], js["opt"]) <= tol


@pytest.mark.parametrize("num_layers,k", DEPTHS, ids=["smoke", "smoke8"])
def test_compact_equals_dense_scatter_bitwise_for_sgd(num_layers, k):
    """Inside the port, SGD: 3 compact steps equal 3 dense-scatter steps
    bitwise (losses and every trainable leaf)."""
    _, ptc = _tcs("sgd", num_layers, k)
    start, plan = make_train_state(ptc, device="cpu")
    out = {}
    for compact in (True, False):
        s = dict(start, params_trainable=tree_map(torch.clone,
                                                  start["params_trainable"]))
        fn = make_train_step(ptc, plan, compact_grads=compact)
        losses = []
        for _ in range(3):
            s, m = fn(s, _tbatch(_batch()))
            losses.append(float(m["loss"]))
        out[compact] = (losses, tree_leaves(s["params_trainable"]))
    assert out[True][0] == out[False][0]
    assert all(torch.equal(a, b) for a, b in zip(out[True][1], out[False][1]))


def test_a_step_calls_each_kernel_wrapper_as_the_card_counts_it(monkeypatch):
    """On the CPU nothing launches, so count the wrapper calls. 8 layers,
    K = 3 (the 2-layer tail and the super-block's 6 layers): the dW once per
    selectable leaf and trainable layer (8 x 6), the fused optimizer once
    per selectable stacked leaf (6 tail + 6 x 6 super-block); no expert dW.
    `chip_smoke.py` derives and asserts the launches on the card."""
    calls = {}
    for name in ("block_sparse_dw", "block_sparse_dw_batched",
                 "fused_block_opt"):
        real = getattr(ops, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **kw)
        monkeypatch.setattr(ops, name, counted)
    _, ptc = _tcs("adamw", 8, 3)
    state, plan = make_train_state(ptc, device="cpu")
    fn = make_train_step(ptc, plan, compact_grads=True)
    for _ in range(2):
        calls.clear()
        state, _ = fn(state, _tbatch(_batch()))
        assert calls == {"block_sparse_dw": 48, "fused_block_opt": 42}


def test_cli_runs_smoke_steps_on_cpu(capsys):
    from repro_torch.launch import train
    out = train.main(["--arch", ARCH, "--smoke", "--steps", "3", "--batch",
                      "2", "--seq", "32", "--update-layers", "1",
                      "--compact-grads", "--channel-block", "8",
                      "--phase-j", "1", "--phase-k", "1", "--log-every", "1",
                      "--device", "cpu"])
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    assert out["plan"].seg_trainable == {"blocks": 1}
    text = capsys.readouterr().out
    assert "DGSU plan" in text and "step     3" in text
