"""The port's jamba family (super-blocks of 7 mamba layers and 1 attention
layer, MoE on every other FFN) against the reference's, on the
jamba-1.5-large-398b smoke config (one super-block, 4 experts top-2), in
f32: the layout and parameter tree, the forward and its auxiliary losses,
the selection plan (the selectable leaves of each `sub{i}`), 3 compact
train steps with SGD, momentum and AdamW against the reference's step under
the MoE tests' top-k tie probe, compact against dense-scatter inside the
port, the kernel wrappers a step calls, and the CLI (also with a `model=`
that replaces the arch's, as `chip_smoke.py` drives its cut)."""
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

ARCH = "jamba-1.5-large-398b"
OPTS = {"sgd": {}, "momentum": {"momentum": 0.9}, "adamw": {}}
SEQ = 32
ATTN = 4                         # attn_every // 2, as the reference's code


def _sub_leaves(i: int) -> dict:
    """The selectable leaves of sub-layer i of a super-block."""
    out = {"attn": {"wq", "wk", "wv", "wo"}} if i == ATTN else \
        {"mamba": {"in_proj", "out_proj"}}
    out["moe" if i % 2 else "mlp"] = {"w_gate", "w_up", "w_down"}
    return out


def _tcs(kind):
    return [C.TrainConfig(
        model=C.get_smoke_config(ARCH),
        shape=C.ShapeConfig("t", SEQ, 2, "train"),
        sparse=C.SparseUpdateConfig(update_ratio=0.5, num_update_layers=1,
                                    channel_block=8),
        optimizer=C.OptimizerConfig(kind=kind, learning_rate=0.05,
                                    **OPTS[kind])) for C in (JC, PC)]


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


@pytest.fixture
def near_tie_probe(monkeypatch):
    """As in tests/test_torch_moe_train.py: records every routed token's
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
    assert gaps and min(gaps) >= 1e-5, (
        f"a routed token has a top-k near-tie (gap {min(gaps)} < 1e-5): "
        f"pick another seed rather than loosen the comparison")


# ---------------------------------------------------------------------------
# layout and forward
# ---------------------------------------------------------------------------

def test_layout_and_param_tree_match_reference():
    """One `jamba_super` step of 8 per 8 layers (9 at full depth); the same
    keys, shapes and dtypes as the reference's tree (smoke; full width on
    the meta device: ~398 B parameters), fp32 router / dt_bias / A_log /
    D in a bf16 model."""
    pcfg, full = PC.get_smoke_config(ARCH), PC.get_config(ARCH)
    assert [tuple(s) for s in PT.segment_layout(pcfg)] == \
        [("blocks", 1, "jamba_super", 8)] == \
        [tuple(s) for s in JT.segment_layout(JC.get_smoke_config(ARCH))]
    assert [tuple(s) for s in PT.segment_layout(full)] == \
        [("blocks", 9, "jamba_super", 8)]
    cases = ((JT.init_params(JC.get_smoke_config(ARCH),
                             jax.random.PRNGKey(0)),
              PT.init_params(pcfg, 0, "cpu")),
             (jax.eval_shape(lambda: JT.init_params(JC.get_config(ARCH),
                                                    jax.random.PRNGKey(0))),
              PT.init_params(full, 0, "meta")))
    for want, port in cases:
        flat_p = jax.tree_util.tree_flatten_with_path(jax.tree.map(
            lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]), port,
            is_leaf=lambda t: isinstance(t, torch.Tensor)))
        flat_j = jax.tree_util.tree_flatten_with_path(
            jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), want))
        assert flat_p[1] == flat_j[1]
        assert [v for _, v in flat_p[0]] == [v for _, v in flat_j[0]]
    blocks = port["segments"]["blocks"]
    for i in range(8):
        assert set(blocks[f"sub{i}"]) == {"mixer_ln", "ffn_ln"} | set(
            _sub_leaves(i))
    assert blocks["sub0"]["mamba"]["A_log"].dtype == torch.float32
    n = sum(t.numel() for t in tree_leaves(port))
    assert 3.9e11 < n < 4.0e11


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_and_aux_losses_match_reference(seed, near_tie_probe):
    """f32: the hidden states, the loss and the MoE aux losses summed over
    the 4 odd sub-layers."""
    jcfg, pcfg = JC.get_smoke_config(ARCH), PC.get_smoke_config(ARCH)
    params = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    batch = _batch(seed=seed + 5)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want, jaux = JT.forward(jcfg, (params, None), jb)
    pp = bridge.to_torch(jax.device_get(params))
    got, aux = PT.forward(pcfg, (pp, None), _tbatch(batch))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(aux.numpy(), np.asarray(jaux), rtol=1e-5)
    assert len(near_tie_probe) == 4
    jl, jm = JT.loss_fn(jcfg, (params, None), jb)
    pl, pm = PT.loss_fn(pcfg, (pp, None), _tbatch(batch))
    for key in ("ce", "load_balance", "router_z"):
        assert float(pm[key]) == pytest.approx(float(jm[key]), rel=1e-5,
                                               abs=1e-5), key
    assert float(pl) == pytest.approx(float(jl), abs=1e-5)


# ---------------------------------------------------------------------------
# plan and train steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
@pytest.mark.parametrize("kw", [
    dict(update_ratio=0.2, num_update_layers=1, channel_block=128),
    dict(update_ratio=0.5, num_update_layers=2, channel_block=8),
])
def test_plan_matches_reference(full, kw):
    """seg_trainable and every SelSpec equal the reference's; each sub{i}
    selects mamba in_proj / out_proj (x_proj, dt_proj, conv_w, A_log are
    excluded) or the 4 attention leaves, and the dense or expert FFN
    leaves (the router takes the dense rule)."""
    get_j = JC.get_config if full else JC.get_smoke_config
    get_p = PC.get_config if full else PC.get_smoke_config
    jplan = jsel.build_plan(get_j(ARCH), JC.SparseUpdateConfig(**kw), 4096)
    pplan = psel.build_plan(get_p(ARCH), PC.SparseUpdateConfig(**kw), 4096)
    assert pplan.seg_trainable == jplan.seg_trainable
    assert _as_tuples(pplan.spec) == _as_tuples(jplan.spec)
    spec = pplan.spec["blocks"]
    assert set(spec) == {f"sub{i}" for i in range(8)}
    for i in range(8):
        assert {g: set(v) for g, v in spec[f"sub{i}"].items()} == \
            _sub_leaves(i), i


@pytest.mark.parametrize("kind,tol", [
    ("sgd", 1e-5),
    ("momentum", 1e-5),
    # the reference's own bound for AdamW (test_compact_path)
    ("adamw", 1e-2),
])
def test_compact_steps_match_reference(kind, tol, near_tie_probe):
    """3 compact fixed-phase steps: losses and aux metrics (1e-5), the
    trainable params (the mamba leaves x_proj, dt_proj, conv, dt_bias,
    A_log, D, the routers and the norms by the dense rule too), the
    selection, the frozen params and the optimizer state against the
    reference's jitted compact step."""
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
        for key in ("loss", "ce", "load_balance", "router_z"):
            assert float(pm[key]) == pytest.approx(float(jm[key]), abs=1e-5,
                                                   rel=1e-5), key
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


@pytest.mark.parametrize("kind,tol", [("sgd", 0.0), ("momentum", 1e-6)])
def test_compact_matches_dense_scatter(kind, tol):
    """In the port: 3 fixed-phase steps of the compact path against the
    dense-scatter path from one start; SGD bitwise (losses too), momentum
    1e-6 (the reference's own bounds)."""
    _, ptc = _tcs(kind)
    sc, plan = make_train_state(ptc, device="cpu")
    sd = dict(sc, params_trainable=tree_map(torch.clone,
                                            sc["params_trainable"]),
              opt=tree_map(torch.clone, sc["opt"]))
    fc = make_train_step(ptc, plan, compact_grads=True)
    fd = make_train_step(ptc, plan, compact_grads=False)
    for _ in range(3):
        sc, mc = fc(sc, _tbatch(_batch()))
        sd, md = fd(sd, _tbatch(_batch()))
        if tol == 0.0:
            assert float(mc["loss"]) == float(md["loss"])
    for a, b in zip(tree_leaves(sc["params_trainable"]),
                    tree_leaves(sd["params_trainable"])):
        assert float((a - b).abs().max()) <= tol
    for a, b in zip(tree_leaves(sc["opt"]), tree_leaves(sd["opt"])):
        assert float((a - b).abs().max()) <= tol


def test_a_step_calls_each_kernel_wrapper_as_the_card_counts_it(monkeypatch):
    """On the CPU nothing launches, so count the wrapper calls. K = 1 (the
    super-block): the dW once per dense selectable leaf (7 mamba layers x 2
    + 4 attention + 4 dense FFNs x 3 = 30), the expert dW once per expert
    leaf (4 MoE FFNs x 3 = 12), the fused optimizer once per selectable
    stacked leaf (42). The full-width cut on the card has the same
    structure, and `chip_smoke.py` derives and asserts its launches."""
    calls = {}
    for name in ("block_sparse_dw", "block_sparse_dw_batched",
                 "fused_block_opt"):
        real = getattr(ops, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **kw)
        monkeypatch.setattr(ops, name, counted)
    _, ptc = _tcs("sgd")
    state, plan = make_train_state(ptc, device="cpu")
    fn = make_train_step(ptc, plan, compact_grads=True)
    for _ in range(2):
        calls.clear()
        state, _ = fn(state, _tbatch(_batch()))
        assert calls == {"block_sparse_dw": 30,
                         "block_sparse_dw_batched": 12,
                         "fused_block_opt": 42}


def test_cli_runs_smoke_steps_on_cpu(capsys):
    """--smoke, and the same run with `model=` a cut of the smoke config
    (2 experts), which replaces the arch's config."""
    from repro_torch.launch import train
    argv = ["--arch", ARCH, "--smoke", "--steps", "3", "--batch", "2",
            "--seq", "32", "--update-layers", "1", "--compact-grads",
            "--channel-block", "8", "--optimizer", "sgd", "--phase-j", "1",
            "--phase-k", "1", "--log-every", "1", "--device", "cpu"]
    out = train.main(argv)
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    assert out["plan"].seg_trainable == {"blocks": 1}
    text = capsys.readouterr().out
    assert "DGSU plan" in text and "step     3" in text
    smoke = PC.get_smoke_config(ARCH)
    cut = dataclasses.replace(smoke, moe=dataclasses.replace(
        smoke.moe, num_experts=2))
    out = train.main(argv, model=cut)
    experts = out["state"]["params_trainable"]["segments"]["blocks"]["sub1"]
    assert experts["moe"]["w_gate"].shape[1] == 2
    assert np.isfinite(out["losses"]).all()
