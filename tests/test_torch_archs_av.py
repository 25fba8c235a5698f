"""The reference's audio and vlm archs in the port, against the reference,
on their smoke configs (f32): musicgen-medium (embedding inputs, gelu,
layernorm) and qwen2-vl-7b (embedding inputs, M-RoPE). Per arch: the
layout and the parameter tree (full width on the meta device, with its
parameter count), the forward and loss, the selection plan, 3 compact
train steps with SGD, momentum and AdamW against the reference's jitted
step (params and selections bridged), compact against dense-scatter inside
the port, prefill and decode against the reference's, the per-arch parts of
the reference's model smoke tests, one bf16 forward, and the launcher's
`batches=` hook. qwen2-vl's positions are a patch grid followed by text, so
their temporal, height and width components differ: with three equal
components M-RoPE is plain RoPE, and a port that ignored the sections
would pass."""
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
from repro.models import decoding as JD  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import make_train_state as jstate  # noqa: E402
from repro.train import make_train_step as jstep  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as PC  # noqa: E402
from repro_torch.core import selection as psel  # noqa: E402
from repro_torch.core.sparse_update import tree_leaves, tree_map  # noqa: E402
from repro_torch.models import decoding as PD  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.train import make_train_state, make_train_step  # noqa: E402

ARCHS = ("musicgen-medium", "qwen2-vl-7b")
OPTS = {"sgd": {}, "momentum": {"momentum": 0.9}, "adamw": {}}
K = 2
# (layout of the full config, its parameter count: the reference's
# eval_shape gives the same)
FULL = {
    "musicgen-medium": ([("blocks", 48, "dense", 1)], 1_362_398_208),
    "qwen2-vl-7b": ([("blocks", 28, "dense", 1)], 7_070_490_112),
}
LEAVES = {
    "musicgen-medium": {"attn": {"wq", "wk", "wv", "wo"},
                        "mlp": {"w_up", "w_down"}},
    "qwen2-vl-7b": {"attn": {"wq", "wk", "wv", "wo"},
                    "mlp": {"w_gate", "w_up", "w_down"}},
}


def grid_positions(b, s, grid=4):
    """[3, b, s] M-RoPE positions: a grid x grid patch grid (t 0, h and w
    its coordinates), then text continuing from the grid's largest + 1."""
    i = np.arange(s)
    n = grid * grid
    text = i - n + grid
    thw = np.stack([np.where(i < n, 0, text), np.where(i < n, i // grid, text),
                    np.where(i < n, i % grid, text)]).astype(np.int32)
    return np.ascontiguousarray(np.broadcast_to(thw[:, None], (3, b, s)))


def _batch(cfg, seed=3, b=2, s=32):
    rng = np.random.default_rng(seed)
    out = {"embeds": rng.standard_normal((b, s, cfg.d_model)).astype(
               np.float32),
           "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.mrope:
        out["positions"] = grid_positions(b, s)
    return out


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tcs(arch, kind="sgd"):
    return [C.TrainConfig(
        model=C.get_smoke_config(arch), shape=C.ShapeConfig("t", 32, 2,
                                                            "train"),
        sparse=C.SparseUpdateConfig(update_ratio=0.5, num_update_layers=K,
                                    channel_block=8),
        optimizer=C.OptimizerConfig(kind=kind, learning_rate=0.05,
                                    **OPTS[kind])) for C in (JC, PC)]


def _max_diff(a, b):
    return max(float(np.abs(np.asarray(x, np.float32)
                            - np.asarray(y, np.float32)).max())
               for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))


def _as_tuples(spec_tree):
    return jax.tree.map(tuple, spec_tree,
                        is_leaf=lambda x: hasattr(x, "n_blocks"))


def _params(arch, seed=1):
    params = JT.init_params(JC.get_smoke_config(arch),
                            jax.random.PRNGKey(seed))
    return params, bridge.to_torch(jax.device_get(params))


def test_grid_positions_differ_in_every_component():
    pos = grid_positions(2, 32)
    assert not (pos[0] == pos[1]).all() and not (pos[1] == pos[2]).all() \
        and not (pos[0] == pos[2]).all()


# ---------------------------------------------------------------------------
# layout, tree, forward, plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_layout_and_tree_match_reference(arch):
    """The segment layout (smoke and full) and the parameter tree's keys,
    shapes and dtypes (smoke on the CPU; full width on the meta device,
    with its parameter count): no token table (embedding inputs, untied
    head)."""
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
    assert sum(int(np.prod(a.shape)) for a in jax.tree.leaves(want)) == want_n
    assert "embed" not in port and "lm_head" in port


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(arch):
    """f32, seq 32: the hidden states and the loss (1e-5)."""
    jcfg, pcfg = JC.get_smoke_config(arch), PC.get_smoke_config(arch)
    params, pp = _params(arch)
    batch = _batch(pcfg, seed=1)
    want, _ = JT.forward(jcfg, (params, None), _jbatch(batch))
    got, aux = PT.forward(pcfg, (pp, None), _tbatch(batch))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert not aux.any()
    jl, jm = JT.loss_fn(jcfg, (params, None), _jbatch(batch))
    pl, pm = PT.loss_fn(pcfg, (pp, None), _tbatch(batch))
    assert float(pl) == pytest.approx(float(jl), abs=1e-5)
    assert float(pm["ce"]) == pytest.approx(float(jm["ce"]), abs=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forward_is_close_to_the_reference(arch):
    """The smoke config in bf16 (the published configs' dtype), bf16 embeds:
    hidden states within 2^-4 of the largest (bf16 rounds every layer)."""
    jcfg = dataclasses.replace(JC.get_smoke_config(arch), dtype="bfloat16")
    pcfg = dataclasses.replace(PC.get_smoke_config(arch), dtype="bfloat16")
    params = JT.init_params(jcfg, jax.random.PRNGKey(1))
    pp = bridge.to_torch(jax.device_get(params))
    batch = _batch(pcfg, seed=1)
    jb = _jbatch(batch)
    jb["embeds"] = jb["embeds"].astype(jnp.bfloat16)
    tb = _tbatch(batch)
    tb["embeds"] = tb["embeds"].to(torch.bfloat16)
    want = np.asarray(JT.forward(jcfg, (params, None), jb)[0], np.float32)
    got = PT.forward(pcfg, (pp, None), tb)[0]
    assert got.dtype == torch.bfloat16
    scale = float(np.abs(want).max())
    assert float(np.abs(got.float().numpy() - want).max()) <= scale * 2**-4


@pytest.mark.parametrize("arch", ARCHS)
def test_model_smoke_parts_of_the_reference_tests(arch):
    """test_models.py's smoke checks for this arch, on the port: the hidden
    shape, finiteness, a random-init CE within 1.5 of ln(V); one sparse SGD
    step: loss finite, frozen params bitwise unchanged, a trainable param
    moved."""
    cfg = PC.get_smoke_config(arch)
    params = PT.init_params(cfg, 0, "cpu")
    batch = _tbatch(_batch(cfg))
    hidden, _ = PT.forward(cfg, (params, None), batch)
    assert hidden.shape == (2, 32, cfg.d_model)
    assert bool(torch.isfinite(hidden).all())
    loss, metrics = PT.loss_fn(cfg, (params, None), batch)
    assert bool(torch.isfinite(loss))
    assert abs(float(metrics["ce"]) - np.log(cfg.vocab_size)) < 1.5

    tc = PC.TrainConfig(
        model=cfg, shape=PC.ShapeConfig("t", 32, 2, "train"),
        sparse=PC.SparseUpdateConfig(update_ratio=0.5, num_update_layers=1,
                                     channel_block=8, phase_fixed_early=100),
        optimizer=PC.OptimizerConfig(kind="sgd", learning_rate=0.1))
    state, plan = make_train_state(tc, device="cpu")
    frozen = tree_map(torch.clone, state["params_frozen"])
    before = tree_map(torch.clone, state["params_trainable"])
    state, m = make_train_step(tc, plan)(state, batch)
    assert bool(torch.isfinite(m["loss"])) and state["step"] == 1
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(frozen), tree_leaves(state["params_frozen"])))
    assert max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(before), tree_leaves(state["params_trainable"]))) > 0


@pytest.mark.parametrize("which", ["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_plan_matches_reference(arch, which):
    kw = dict(update_ratio=0.2, num_update_layers=2, channel_block=128) \
        if which == "full" else dict(update_ratio=0.5, num_update_layers=2,
                                     channel_block=8)
    get_j = JC.get_config if which == "full" else JC.get_smoke_config
    get_p = PC.get_config if which == "full" else PC.get_smoke_config
    jplan = jsel.build_plan(get_j(arch), JC.SparseUpdateConfig(**kw), 8192)
    pplan = psel.build_plan(get_p(arch), PC.SparseUpdateConfig(**kw), 8192)
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
def test_compact_steps_match_reference(arch, kind, tol):
    """3 compact fixed-phase steps, K = 2: losses (1e-5), trainable params,
    selection, frozen params and optimizer state against the reference's
    jitted compact step."""
    jtc, ptc = _tcs(arch, kind)
    js, jplan = jstate(jtc, jax.random.PRNGKey(0))
    pplan = psel.build_plan(ptc.model, ptc.sparse, 64)
    ps = bridge.state_to_torch(jax.device_get(js))
    jfn = jax.jit(jstep(jtc, jplan, compact_grads=True))
    pfn = make_train_step(ptc, pplan, compact_grads=True)
    batch = _batch(ptc.model)
    for _ in range(3):
        js, jm = jfn(js, _jbatch(batch))
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
    _, ptc = _tcs(arch)
    start, plan = make_train_state(ptc, device="cpu")
    out = {}
    for compact in (True, False):
        s = dict(start, params_trainable=tree_map(torch.clone,
                                                  start["params_trainable"]))
        fn = make_train_step(ptc, plan, compact_grads=compact)
        losses = []
        for _ in range(3):
            s, m = fn(s, _tbatch(_batch(ptc.model)))
            losses.append(float(m["loss"]))
        out[compact] = (losses, tree_leaves(s["params_trainable"]))
    assert out[True][0] == out[False][0]
    assert all(torch.equal(a, b) for a, b in zip(out[True][1], out[False][1]))


# ---------------------------------------------------------------------------
# prefill / decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """f32: prefill of 20 positions (logits and cache, 1e-5), then 4
    decode steps fed fresh embeddings at their positions (qwen2-vl: [3, B,
    1] positions continuing every component) against the reference's."""
    jcfg, pcfg = JC.get_smoke_config(arch), PC.get_smoke_config(arch)
    params, pp = _params(arch)
    batch = _batch(pcfg, b=2, s=24)
    s0 = 20
    pf = {k: (v[:, :s0] if k != "positions" else v[..., :s0])
          for k, v in batch.items() if k != "labels"}
    jl, jc = JD.prefill(jcfg, params, _jbatch(pf), pad_to=24)
    pl, pc = PD.prefill(pcfg, pp, _tbatch(pf), pad_to=24)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    for key in ("k", "v"):
        np.testing.assert_allclose(pc["blocks"][key].numpy(),
                                   np.asarray(jc["blocks"][key]), rtol=1e-5,
                                   atol=1e-5)
    for t in range(s0, 24):
        db = {"embeds": batch["embeds"][:, t:t + 1],
              "positions": (batch["positions"][..., t:t + 1] if pcfg.mrope
                            else np.full((2, 1), t, np.int32))}
        jl, jc = JD.decode_step(jcfg, params, _jbatch(db), jc)
        pl, pc = PD.decode_step(pcfg, pp, _tbatch(db), pc)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_forward(arch):
    """The reference's test_prefill_decode_matches_forward on the port:
    prefill of 20 positions, then decode steps, against the full forward's
    logits at each position (its tolerances: rtol 5e-2, atol 5e-3)."""
    cfg = PC.get_smoke_config(arch)
    params = PT.init_params(cfg, 0, "cpu")
    batch = _tbatch(_batch(cfg, b=2, s=24))
    hidden, _ = PT.forward(cfg, (params, None), batch)
    ref = hidden @ PT.lm_head_weight(cfg, (params, None))
    s0 = 20
    pf = {k: (v[:, :s0] if k != "positions" else v[..., :s0])
          for k, v in batch.items() if k != "labels"}
    logits, cache = PD.prefill(cfg, params, pf, pad_to=24)
    np.testing.assert_allclose(logits.numpy(), ref[:, s0 - 1].detach(),
                               rtol=5e-2, atol=5e-3)
    for t in range(s0, 24):
        db = {"embeds": batch["embeds"][:, t:t + 1],
              "positions": (batch["positions"][..., t:t + 1] if cfg.mrope
                            else torch.full((2, 1), t))}
        logits, cache = PD.decode_step(cfg, params, db, cache)
        np.testing.assert_allclose(logits.numpy(), ref[:, t].detach(),
                                   rtol=5e-2, atol=5e-3)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

ARGV = ["--smoke", "--steps", "3", "--batch", "2", "--seq", "32",
        "--update-layers", "2", "--compact-grads", "--channel-block", "8",
        "--phase-j", "1", "--phase-k", "1", "--log-every", "1", "--device",
        "cpu"]


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_refuses_embed_archs_without_batches(arch, capsys):
    from repro_torch.launch import train
    with pytest.raises(SystemExit):
        train.main(["--arch", arch] + ARGV)
    assert "batches=" in capsys.readouterr().err


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_trains_on_the_batches_hook(arch):
    """main(argv, batches=...) runs 3 steps on the stream's batches from
    step 0, and the same losses as a step function fed them directly."""
    from repro_torch.launch import train
    cfg = PC.get_smoke_config(arch)
    starts = []

    def stream(start):
        starts.append(start)
        step = start
        while True:
            yield _tbatch(_batch(cfg, seed=step))
            step += 1
    out = train.main(["--arch", arch] + ARGV, batches=stream)
    assert starts == [0] and len(out["losses"]) == 3
    args = train.build_argparser().parse_args(["--arch", arch] + ARGV)
    tc = train.train_config(args)
    state, plan = make_train_state(tc, device="cpu")
    fn = make_train_step(tc, plan)
    for step in range(3):
        state, m = fn(state, _tbatch(_batch(cfg, seed=step)))
        assert float(m["loss"]) == out["losses"][step]
