"""The reference's three other text-only archs in the port, against the
reference, on their smoke configs (f32): nemotron-4-15b (layernorm with a
bias, squared-ReLU MLP), command-r-35b (layernorm, swiglu, tied
embeddings) and llama4-scout-17b-a16e (MoE in every layer, top-1 routing
plus one shared expert). Per arch: the layout and the parameter tree
(full width on the meta device), the forward and loss, the selection plan,
3 compact train steps with SGD, momentum and AdamW against the reference's
jitted step (params and selections bridged), compact against dense-scatter
inside the port, the kernel wrappers a step calls, and the CLI."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from repro_torch.testing import limit_threads  # noqa: E402

limit_threads()
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.core import selection as jsel  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import make_train_state as jstate  # noqa: E402
from repro.train import make_train_step as jstep  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as PC  # noqa: E402
from repro_torch.core import selection as psel  # noqa: E402
from repro_torch.core.sparse_update import tree_leaves, tree_map  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import moe as PMOE  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.train import make_train_state, make_train_step  # noqa: E402

ARCHS = ("nemotron-4-15b", "command-r-35b", "llama4-scout-17b-a16e")
OPTS = {"sgd": {}, "momentum": {"momentum": 0.9}, "adamw": {}}
K = 2
# (layout of the full config, its parameter count)
FULL = {
    "nemotron-4-15b": ([("blocks", 32, "dense", 1)], 15_628_775_424),
    "command-r-35b": ([("blocks", 40, "dense", 1)], 30_284_201_984),
    "llama4-scout-17b-a16e": ([("blocks", 48, "moe", 1)], 107_769_861_120),
}
# the selectable leaves of one trainable layer
LEAVES = {
    "nemotron-4-15b": {"attn": {"wq", "wk", "wv", "wo"},
                       "mlp": {"w_up", "w_down"}},
    "command-r-35b": {"attn": {"wq", "wk", "wv", "wo"},
                      "mlp": {"w_gate", "w_up", "w_down"}},
    "llama4-scout-17b-a16e": {"attn": {"wq", "wk", "wv", "wo"},
                              "moe": {"w_gate", "w_up", "w_down", "shared"}},
}


def _tcs(arch, kind="sgd"):
    return [C.TrainConfig(
        model=C.get_smoke_config(arch), shape=C.ShapeConfig("t", 32, 2,
                                                            "train"),
        sparse=C.SparseUpdateConfig(update_ratio=0.5, num_update_layers=K,
                                    channel_block=8),
        optimizer=C.OptimizerConfig(kind=kind, learning_rate=0.05,
                                    **OPTS[kind])) for C in (JC, PC)]


def _batch(seed=3, b=2, s=32):
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


@pytest.fixture
def near_tie_probe(monkeypatch):
    """Records, for every routed token of every MoE call of the port, the
    gap between its k-th and (k+1)-th router probability; fails on a gap
    below 1e-5, where one ulp of the fp32 logits can route the token
    differently in the two frameworks."""
    gaps = []
    inner = PMOE.apply_moe

    def probed(p, cfg, x, sel=None):
        with torch.no_grad():
            _, probs, _, _ = PMOE.route(p["router"],
                                        x.reshape(-1, x.shape[-1]),
                                        cfg.moe.top_k + 1)
            top = torch.topk(probs, cfg.moe.top_k + 1, dim=-1).values
            gaps.append(float((top[:, -2] - top[:, -1]).min()))
        return inner(p, cfg, x, sel)

    monkeypatch.setattr(PMOE, "apply_moe", probed)
    yield gaps
    assert min(gaps, default=1.0) >= 1e-5, (
        f"a routed token has a top-k near-tie (gap {min(gaps)} < 1e-5): "
        f"pick another seed rather than loosen the comparison")


# ---------------------------------------------------------------------------
# layout, tree, forward, plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_layout_and_tree_match_reference(arch):
    """The segment layout (smoke and full) and the parameter tree's keys,
    shapes and dtypes (smoke on the CPU; full width on the meta device,
    with its parameter count)."""
    want_layout, want_n = FULL[arch]
    for get_j, get_p in ((JC.get_smoke_config, PC.get_smoke_config),
                         (JC.get_config, PC.get_config)):
        assert [tuple(s) for s in PT.segment_layout(get_p(arch))] == \
            [tuple(s) for s in JT.segment_layout(get_j(arch))]
    assert [tuple(s) for s in PT.segment_layout(PC.get_config(arch))] == \
        want_layout
    cases = ((JT.init_params(JC.get_smoke_config(arch),
                             jax.random.PRNGKey(0)),
              PT.init_params(PC.get_smoke_config(arch), 0, "cpu")),
             (jax.eval_shape(lambda: JT.init_params(JC.get_config(arch),
                                                    jax.random.PRNGKey(0))),
              PT.init_params(PC.get_config(arch), 0, "meta")))
    for want, port in cases:
        flat_p = jax.tree_util.tree_flatten_with_path(jax.tree.map(
            lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]), port,
            is_leaf=lambda t: isinstance(t, torch.Tensor)))
        flat_j = jax.tree_util.tree_flatten_with_path(
            jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), want))
        assert flat_p[1] == flat_j[1]
        assert [v for _, v in flat_p[0]] == [v for _, v in flat_j[0]]
    assert sum(t.numel() for t in tree_leaves(port)) == want_n
    cfg = PC.get_config(arch)
    assert ("lm_head" in port) != cfg.tie_embeddings
    assert ("bias" in port["final_norm"]) == (cfg.norm_kind == "layernorm")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(arch, near_tie_probe):
    """f32, seq 32: the hidden states (1e-5), the loss and its metrics
    (1e-5; llama4-scout's load-balance and router z-losses too)."""
    jcfg, pcfg = JC.get_smoke_config(arch), PC.get_smoke_config(arch)
    params = JT.init_params(jcfg, jax.random.PRNGKey(1))
    batch = _batch(seed=1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    pp = bridge.to_torch(jax.device_get(params))
    want, want_aux = JT.forward(jcfg, (params, None), jb)
    got, aux = PT.forward(pcfg, (pp, None), _tbatch(batch))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(aux.numpy(), np.asarray(want_aux), rtol=1e-5,
                               atol=1e-5)
    jl, jm = JT.loss_fn(jcfg, (params, None), jb)
    pl, pm = PT.loss_fn(pcfg, (pp, None), _tbatch(batch))
    assert float(pl) == pytest.approx(float(jl), abs=1e-5)
    for key in ("ce", "load_balance", "router_z"):
        assert float(pm[key]) == pytest.approx(float(jm[key]), abs=1e-5)
    assert bool(aux.any()) == (pcfg.moe is not None)


@pytest.mark.parametrize("which", ["smoke", "full"])
@pytest.mark.parametrize("kw", [
    dict(update_ratio=0.2, num_update_layers=2, channel_block=128),
    dict(update_ratio=0.5, num_update_layers=2, channel_block=8),
])
@pytest.mark.parametrize("arch", ARCHS)
def test_plan_matches_reference(arch, kw, which):
    """seg_trainable and the SelSpec tree equal the reference's; the
    selectable leaves of a trainable layer (llama4-scout: the routed
    experts' three leaves and the shared expert's MLP, not the router)."""
    get_j = JC.get_config if which == "full" else JC.get_smoke_config
    get_p = PC.get_config if which == "full" else PC.get_smoke_config
    jplan = jsel.build_plan(get_j(arch), JC.SparseUpdateConfig(**kw), 4096)
    pplan = psel.build_plan(get_p(arch), PC.SparseUpdateConfig(**kw), 4096)
    assert pplan.seg_trainable == jplan.seg_trainable == {"blocks": 2}
    assert _as_tuples(pplan.spec) == _as_tuples(jplan.spec)
    assert {g: set(v) for g, v in pplan.spec["blocks"].items()} == \
        LEAVES[arch]


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,tol", [
    ("sgd", 1e-5),
    ("momentum", 1e-5),
    # the reference's own bound for AdamW (test_compact_path): g/sqrt(g^2)
    # turns fp32 summation-order differences in near-zero gradients into
    # O(lr) update differences
    ("adamw", 1e-2),
])
@pytest.mark.parametrize("arch", ARCHS)
def test_compact_steps_match_reference(arch, kind, tol, near_tie_probe):
    """3 compact fixed-phase steps, K = 2: losses (1e-5), trainable params
    (the layernorms' scale and bias by the dense rule too), selection,
    frozen params and optimizer state against the reference's jitted
    compact step."""
    jtc, ptc = _tcs(arch, kind)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_compact_equals_dense_scatter_bitwise_for_sgd(arch):
    """Inside the port, SGD: 3 compact steps equal 3 dense-scatter steps
    bitwise (losses and every trainable leaf)."""
    _, ptc = _tcs(arch)
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


# per step at K = 2: the dW once per selectable leaf and trainable layer
# (llama4-scout: attention and the shared expert's 3 leaves dense, the 3
# routed expert leaves batched), the fused optimizer once per selectable
# stacked leaf
WRAPPER_CALLS = {
    "nemotron-4-15b": {"block_sparse_dw": 12, "fused_block_opt": 6},
    "command-r-35b": {"block_sparse_dw": 14, "fused_block_opt": 7},
    "llama4-scout-17b-a16e": {"block_sparse_dw": 14,
                              "block_sparse_dw_batched": 6,
                              "fused_block_opt": 10},
}


@pytest.mark.parametrize("arch", ARCHS)
def test_a_step_calls_each_kernel_wrapper_as_the_card_counts_it(
        arch, monkeypatch):
    """On the CPU nothing launches, so count the wrapper calls of two
    AdamW steps. `chip_smoke.py` derives and asserts the launches on the
    card."""
    calls = {}
    for name in ("block_sparse_dw", "block_sparse_dw_batched",
                 "fused_block_opt"):
        real = getattr(ops, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **kw)
        monkeypatch.setattr(ops, name, counted)
    _, ptc = _tcs(arch, "adamw")
    state, plan = make_train_state(ptc, device="cpu")
    fn = make_train_step(ptc, plan, compact_grads=True)
    for _ in range(2):
        calls.clear()
        state, _ = fn(state, _tbatch(_batch()))
        assert calls == WRAPPER_CALLS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_runs_smoke_steps_on_cpu(arch, capsys):
    from repro_torch.launch import train
    out = train.main(["--arch", arch, "--smoke", "--steps", "3", "--batch",
                      "2", "--seq", "32", "--update-layers", "2",
                      "--compact-grads", "--channel-block", "8",
                      "--phase-j", "1", "--phase-k", "1", "--log-every", "1",
                      "--device", "cpu"])
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    assert out["plan"].seg_trainable == {"blocks": 2}
    text = capsys.readouterr().out
    assert "DGSU plan" in text and "step     3" in text
