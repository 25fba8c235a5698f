"""The port's train step on a (data, model) process mesh against the
reference's single-device step, on the CPU.

One world of 4 gloo ranks is spawned for the module, and every case runs
inside it (`launch.mesh_train.run_jobs`; a (1, 2) or (2, 1) case uses the
first 2 ranks). The ranks import only torch and the port; this process
computes the reference meanwhile and hands the ranks numpy arrays: the
reference's params, its selection (built under the same rules: the plan
`build_plan` gives under a fake mesh of the case's shape, as the
reference's own sharding test builds one) and the batches. The reference
then runs its ordinary single-device step with that plan. In the cases
that cover the ranks' own set-up (every attention family, the dynamic
phase) the ranks draw their params from the seed and select by magnitude
on their shards, and the reference takes one process's draw of the same
numbers; through the dynamic phase the reference is handed the port's
selection for every step. The recurrent families (rwkv6-3b, jamba) run on
(1, 2) and (2, 2) the same way, and jamba's first-step gradients of every
mamba leaf are held against the reference's.

Bounds, f32: losses and MoE metrics 1e-5 (relative and absolute); updated
params 1e-5 absolute (sgd, momentum: `test_torch_train`'s, and the rwkv
and jamba one-device tests' bound); the compact dW 1e-5 relative to its
largest entry; the mamba dense-rule gradients relative 1e-4
(`test_torch_mamba`'s) and 1e-5 of their largest entry; unselected blocks
of the trainable layers and every frozen param bitwise. bf16: losses
within 2e-2 relative of the reference's f32 run from the same params.
"""
import concurrent.futures
import dataclasses
import threading
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from repro_torch.testing import limit_threads  # noqa: E402

limit_threads()
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.core.selection import build_plan as jbuild_plan  # noqa: E402
from repro.core.selection import magnitude_selection as jmagnitude  # noqa: E402
from repro.core.sparse_update import gather_selected_tree, map_selectable  # noqa: E402
from repro.launch.specs import rules_for as jrules_for  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import init_opt_state  # noqa: E402
from repro.sharding import default_rules as jdefault  # noqa: E402
from repro.sharding import use_rules as juse  # noqa: E402
from repro.train import make_train_step as jstep  # noqa: E402
from repro.train.steps import split_params as jsplit  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch import configs as PC  # noqa: E402
from repro_torch import sharding as SH  # noqa: E402
from repro_torch.launch import mesh, mesh_train  # noqa: E402
from repro_torch.core.schedule import maybe_reselect as pmaybe_reselect  # noqa: E402
from repro_torch.core.selection import build_plan as pbuild_plan  # noqa: E402
from repro_torch.launch import specs as S  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.models.specs import param_logical_specs  # noqa: E402

WORLD = 4
PROBE = dict(name="collectives", kind="collectives", mesh=(1, 2))
SEQ = 16
LOSS = dict(rel=1e-5, abs=1e-5)
PARAMS = 1e-5


def _tc(C, arch, *, steps, kind="momentum", dtype=None, seq=SEQ,
        grad_clip=0.0, moe_cf=None, ratio=0.5):
    cfg = C.get_smoke_config(arch)
    if dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    if moe_cf:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=moe_cf))
    return C.TrainConfig(
        model=cfg, shape=C.ShapeConfig("t", seq, 4, "train"),
        sparse=C.SparseUpdateConfig(update_ratio=ratio, num_update_layers=2,
                                    channel_block=8,
                                    phase_fixed_early=steps),
        optimizer=C.OptimizerConfig(kind=kind, learning_rate=0.1,
                                    momentum=0.9 if kind == "momentum"
                                    else 0.0, grad_clip=grad_clip))


def _fake(shape):
    return SimpleNamespace(shape={"data": shape[0], "model": shape[1]},
                           axis_names=("data", "model"))


def _batches(cfg, n, seq, seed):
    """Token batches, or embeddings for the embedding-input archs, with
    distinct M-RoPE components for qwen2-vl."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        if cfg.embed_inputs:
            b = {"embeds": rng.standard_normal((4, seq, cfg.d_model))
                 .astype(np.float32)}
        else:
            b = {"tokens": rng.integers(0, cfg.vocab_size, (4, seq))
                 .astype(np.int32)}
        b["labels"] = rng.integers(0, cfg.vocab_size, (4, seq)) \
            .astype(np.int32)
        if cfg.mrope:
            pos = np.broadcast_to(np.arange(seq, dtype=np.int32),
                                  (3, 4, seq)).copy()
            pos[1] //= 4
            pos[2] %= 4
            b["positions"] = pos
        out.append(b)
    return out


_PARAMS: dict = {}


def _init(pcfg):
    """f32 params from seed 0 (the port's draw, as numpy: both packages
    take the same arrays), drawn once a config."""
    key = repr(pcfg)
    if key not in _PARAMS:
        _PARAMS[key] = bridge.to_numpy(PT.init_params(pcfg, 0, "cpu"))
    return _PARAMS[key]


def _to_bf16(params):
    """f32 params -> the port's bf16 model's (the router stays f32)."""
    import ml_dtypes
    return jax.tree_util.tree_map_with_path(
        lambda path, a: a if path[-1].key == "router"
        else a.astype(ml_dtypes.bfloat16), params)


class Case:
    """One mesh case: the reference's inputs and run, and the ranks' job.

    given_params False: the ranks draw their params from the seed
    (`init_params(..., rules=)`, each keeping its slice) and the reference
    takes one process's draw of the same numbers. given_sel False: the
    ranks select by magnitude on their shards. dynamic: the port's phase
    settings with a dynamic window; the ranks reselect on their own (the
    plan's fresh draws, a pure function of (seed, step, segment, leaf)),
    and the reference, its phases fixed, is handed the port's selection
    for every step (`core.schedule.maybe_reselect`, as numpy)."""

    def __init__(self, name, arch, shape, *, rules="train", steps=3,
                 compact=True, cgr=False, kind="momentum", dtype=None,
                 seq=SEQ, grad_clip=0.0, moe_cf=None, given_sel=True,
                 given_params=True, ratio=0.5, dynamic=None,
                 returns=("params", "frozen"), ref_of=None):
        self.name, self.arch, self.shape = name, arch, shape
        self.rules, self.steps, self.compact = rules, steps, compact
        kw = dict(steps=steps, kind=kind, seq=seq, grad_clip=grad_clip,
                  moe_cf=moe_cf, ratio=ratio)
        # the reference without recomputation (the same numbers, a
        # quicker compile); the port's ranks recompute, collectives and all
        self.jtc = dataclasses.replace(_tc(JC, arch, **kw), remat="none")
        self.ptc = _tc(PC, arch, dtype=dtype, **kw)
        if dynamic:
            self.ptc = dataclasses.replace(self.ptc, sparse=dataclasses
                                           .replace(self.ptc.sparse,
                                                    **dynamic))
        self.ref_of = ref_of
        jcfg = self.jtc.model
        self.batches = _batches(jcfg, steps, seq, seed=7)
        self.job = dict(name=name, cfg=self.ptc.model, mesh=shape,
                        rules=rules, tc=self.ptc, steps=steps,
                        compact=compact, cgr=cgr, params=None, sel_idx=None,
                        batches=self.batches, returns=returns)
        self.params = _init(_tc(PC, arch, **kw).model)
        rules_ = jrules_for(_fake(shape), jcfg, self.jtc.shape) \
            if rules == "train" else jdefault(_fake(shape))
        with juse(rules_):
            self.plan = jbuild_plan(jcfg, self.jtc.sparse)
        self.sel = jax.device_get(jmagnitude(self.plan, self.params))
        self.sels = self._port_selections() if dynamic else [self.sel] * steps
        params = jax.tree.map(np.asarray, self.params)
        if dtype == "bfloat16":
            params = _to_bf16(params)
        self.job.update(
            params=params if given_params else None,
            sel_idx=jax.tree.map(np.asarray, self.sel) if given_sel
            else None)

    def _port_selections(self):
        """The selection the port's step uses at every step: the start one,
        then its schedule's draws."""
        fake = _fake(self.shape)
        with SH.use_rules(S.rules_for(fake, self.ptc.model, self.ptc.shape)):
            pplan = pbuild_plan(self.ptc.model, self.ptc.sparse)
        cur, out = self.sel, []
        for step in range(self.steps):
            new = pmaybe_reselect(pplan, self.ptc.sparse, cur, step,
                                  self.ptc.seed, "cpu")
            cur = cur if new is cur else bridge.to_numpy(new)
            out.append(cur)
        return out

    def reference(self):
        """The reference's single-device steps under the case's plan and
        selections: per-step metrics and the final trainable params."""
        frozen, trainable = jsplit(self.params, self.plan)
        state = {"step": jnp.zeros((), jnp.int32),
                 "params_trainable": trainable, "params_frozen": frozen,
                 "opt": init_opt_state(self.jtc.optimizer, trainable),
                 "sel_idx": self.sel, "rng": jax.random.PRNGKey(1)}
        fn = jax.jit(jstep(self.jtc, self.plan, donate=False,
                           compact_grads=self.compact))
        rows = []
        for b, sel in zip(self.batches, self.sels):
            state["sel_idx"] = jax.tree.map(jnp.asarray, sel)
            state, m = fn(state, {k: jnp.asarray(v) for k, v in b.items()})
            rows.append({k: float(v) for k, v in m.items()})
        self.ref_rows = rows
        self.ref_trainable = jax.device_get(state["params_trainable"])
        self.init_trainable = jax.device_get(trainable)


def _ref_compact_grads(case):
    """The reference's first-step compact dW (`g_sel`), as its compact
    step computes it."""
    return _ref_grads(case)[1]


def _ref_grads(case):
    """The reference's first-step gradients as its compact step computes
    them: (the dense-rule leaves' full gradients, the compact dW)."""
    cfg, plan = case.jtc.model, case.plan
    frozen, trainable = jsplit(case.params, plan)
    batch = {k: jnp.asarray(v) for k, v in case.batches[0].items()}
    wsel = gather_selected_tree(trainable["segments"], case.sel, plan.spec)

    def loss_of(diff):
        t_tree, ws = diff
        stopped = map_selectable(t_tree, {"segments": plan.spec},
                                 jax.lax.stop_gradient)
        return JT.loss_fn(cfg, (frozen, stopped), batch,
                          sel=(case.sel, plan.spec, ws), remat=False)

    (_, _), (g_dense, g_sel) = jax.jit(jax.value_and_grad(
        loss_of, has_aux=True))((trainable, wsel))
    return jax.device_get(g_dense), jax.device_get(g_sel)


def _cases():
    return [
        Case("llama_rules_for", "llama3-8b", (2, 2), given_sel=False,
             grad_clip=0.05,
             returns=("params", "frozen", "sel_idx", "grads")),
        Case("dense_scatter", "llama3-8b", (2, 2), rules="default",
             compact=False, steps=2, kind="sgd"),
        Case("dense_scatter_cgr", "llama3-8b", (2, 2), rules="default",
             compact=False, cgr=True, steps=2, kind="sgd",
             ref_of="dense_scatter"),
        Case("moe_1x2", "deepseek-moe-16b", (1, 2), steps=2, moe_cf=8.0),
        Case("moe_2x1", "deepseek-moe-16b", (2, 1), steps=2, moe_cf=8.0),
        Case("gemma_1x2", "gemma3-4b", (1, 2), steps=2, seq=32, kind="sgd"),
        Case("bf16", "llama3-8b", (2, 2), dtype="bfloat16", steps=2,
             returns=(), ref_of="llama_rules_for"),
        # the recurrent families: rwkv's channel mix d_ff-parallel beside
        # its whole time mix, jamba's mamba d_inner-parallel (the first
        # step's gradients of every mamba leaf returned); on (1, 2) the
        # ranks select by magnitude on their shards
        Case("rwkv_1x2", "rwkv6-3b", (1, 2), steps=2, kind="sgd",
             given_sel=False, returns=("params", "frozen", "sel_idx")),
        Case("rwkv_2x2", "rwkv6-3b", (2, 2), steps=2),
        Case("jamba_1x2", "jamba-1.5-large-398b", (1, 2), steps=2,
             kind="sgd", moe_cf=8.0, given_sel=False,
             returns=("params", "frozen", "sel_idx", "grads")),
        Case("jamba_2x2", "jamba-1.5-large-398b", (2, 2), steps=2,
             moe_cf=8.0),
        Case("dynamic", "llama3-8b", (2, 2), kind="sgd", ratio=0.25,
             given_params=False, given_sel=False,
             dynamic=dict(phase_fixed_early=1, phase_dynamic=2),
             returns=("params", "frozen", "sel_idx")),
    ] + [Case(arch, arch, (2, 2), steps=2, kind="sgd",
              moe_cf=8.0 if "scout" in arch else None, given_params=False,
              given_sel=False) for arch in FAMILIES]


FAMILIES = ["nemotron-4-15b", "command-r-35b", "musicgen-medium",
            "qwen2-vl-7b", "llama4-scout-17b-a16e"]


@pytest.fixture(scope="module")
def runs():
    cases = {c.name: c for c in _cases()}
    out = {}

    def ranks():
        try:
            jobs = [c.job for c in cases.values()] + [PROBE]
            out["ranks"] = mesh.spawn(mesh_train.run_jobs, WORLD,
                                      args=(jobs,), timeout_s=240)
        except BaseException as e:  # re-raised in the test process below
            out["error"] = e

    t = threading.Thread(target=ranks)
    t.start()
    # the reference's steps compile side by side (XLA compiles outside
    # the GIL) while the ranks run
    todo = [c for c in cases.values() if c.ref_of is None]
    with concurrent.futures.ThreadPoolExecutor(len(todo) + 1) as pool:
        jobs = [pool.submit(c.reference) for c in todo]
        g = pool.submit(_ref_compact_grads, cases["llama_rules_for"])
        gj = pool.submit(_ref_grads, cases["jamba_1x2"])
        for f in jobs:
            f.result()
        grads = g.result()
        grads_jamba = gj.result()
    for c in cases.values():
        if c.ref_of is not None:
            src = cases[c.ref_of]
            c.ref_rows, c.ref_trainable, c.init_trainable = \
                src.ref_rows, src.ref_trainable, src.init_trainable
    t.join()
    if "error" in out:
        raise out["error"]
    per_case = {}
    for i, name in enumerate(list(cases) + ["collectives"]):
        per_case[name] = [r[i] for r in out["ranks"] if r[i] is not None]
    cases["jamba_1x2"].ref_grads = grads_jamba
    return cases, per_case, grads


def _gathered(case, results):
    """The ranks' trainable shards put together."""
    fake = _fake(case.shape)
    rules = S.rules_for(fake, case.ptc.model, case.ptc.shape) \
        if case.rules == "train" else SH.default_rules(fake)
    sh = S.tree_shardings(case.ref_trainable,
                          param_logical_specs(case.ptc.model), rules)
    return S.gather_shards([r["params"] for r in results],
                           [r["coords"] for r in results], sh, fake.shape)


def _selected_mask(shape, idx, spec):
    """True on the selected blocks of a stacked leaf [K, *lead, N]."""
    k, n = shape[0], shape[-1]
    m = np.zeros((k, spec.n_shards, spec.n_blocks), bool)
    for kk in range(k):
        for s in range(spec.n_shards):
            m[kk, s, np.asarray(idx)[kk, s]] = True
    m = np.repeat(m.reshape(k, -1), spec.block, axis=1)
    return np.broadcast_to(m.reshape((k,) + (1,) * (len(shape) - 2) + (n,)),
                           shape)


def _check_metrics(case, results, keys=("loss",)):
    for r in results:
        assert len(r["steps"]) == case.steps
        for got, want in zip(r["steps"], case.ref_rows):
            for key in keys:
                assert got[key] == pytest.approx(want[key], **LOSS), \
                    (case.name, r["coords"], key)


def _check_params(case, results):
    got = _gathered(case, results)
    for path, want in jax.tree_util.tree_leaves_with_path(
            case.ref_trainable):
        a = got
        for p in path:
            a = a[p.key]
        np.testing.assert_allclose(np.asarray(a), np.asarray(want),
                                   atol=PARAMS, rtol=0,
                                   err_msg=f"{case.name} {path}")
    # blocks no step selected, of the selectable leaves: bitwise their start
    for seg, spec_tree in case.plan.spec.items():
        if case.sel.get(seg) is None:
            continue

        def walk(spec, idxs, g, init, path):
            if not isinstance(spec, dict):
                mask = np.logical_or.reduce(
                    [_selected_mask(init.shape, idx, spec) for idx in idxs])
                assert np.array_equal(np.asarray(g)[~mask],
                                      np.asarray(init)[~mask]), path
                return
            for key in spec:
                walk(spec[key], [i[key] for i in idxs], g[key], init[key],
                     path + (key,))
        walk(spec_tree, [sel[seg] for sel in case.sels],
             got["segments"][seg], case.init_trainable["segments"][seg],
             (seg,))
    for r in results:
        assert r["frozen_unchanged"], (case.name, r["coords"])


def test_llama_rules_for_2x2_matches_the_reference(runs):
    """llama3-8b smoke on a (2, 2) mesh under rules_for (kv heads whole):
    3 compact momentum steps with the global-norm clip active, losses per
    step, the gathered params, unselected and frozen blocks bitwise."""
    cases, res, _ = runs
    case = cases["llama_rules_for"]
    assert len(res[case.name]) == 4
    _check_metrics(case, res[case.name])
    _check_params(case, res[case.name])


def test_replicated_kv_compact_dw_is_summed_once(runs):
    """The first step's compact dW after every reduction, against the
    reference's g_sel: wk / wv (whole on every rank, their gradient summed
    over the model group once: a missing or doubled sum fails here), wq
    and w_gate (each rank its own shard), wo and w_down (each rank its
    own input rows)."""
    cases, res, ref = runs
    case = cases["llama_rules_for"]
    spec = case.plan.spec["blocks"]
    hd = case.jtc.model.resolved_head_dim
    for r in res[case.name]:
        m = r["coords"]["model"]
        got = r["grads"]["compact"]["blocks"]
        for sub, names in (("attn", ("wq", "wk", "wv", "wo")),
                           ("mlp", ("w_gate", "w_up", "w_down"))):
            for name in names:
                want = np.asarray(ref["blocks"][sub][name])
                sp = spec[sub][name]
                if sp.n_shards > 1:               # column-parallel
                    want = want[:, :, m:m + 1]
                elif name in ("wo", "w_down"):    # row-parallel
                    rows = want.shape[1] // 2
                    want = want[:, m * rows:(m + 1) * rows]
                g = np.asarray(got[sub][name])
                assert g.shape == want.shape, (name, g.shape, want.shape)
                scale = float(np.abs(want).max())
                np.testing.assert_allclose(g, want, rtol=0,
                                           atol=1e-5 * scale,
                                           err_msg=f"{name} rank {m}")
    assert spec["attn"]["wk"].n_shards == 1 and hd > 0


def test_magnitude_selection_on_the_mesh_matches_the_reference(runs):
    """Every rank's magnitude selection, made on its shards (the
    row-parallel wo / w_down sum their squared norms over the model
    group first), is its shard of the reference's."""
    cases, res, _ = runs
    case = cases["llama_rules_for"]
    for r in res[case.name]:
        m = r["coords"]["model"]
        got = r["sel_idx"]["blocks"]
        for sub in ("attn", "mlp"):
            for name, sp in case.plan.spec["blocks"][sub].items():
                want = np.asarray(case.sel["blocks"][sub][name])
                if sp.n_shards > 1:
                    want = want[:, m:m + 1]
                np.testing.assert_array_equal(got[sub][name], want,
                                              err_msg=name)


def test_dense_scatter_with_and_without_compact_allreduce(runs):
    """The dense-scatter step on (2, 2) under default_rules (kv heads
    split): against the reference's, and compact_allreduce gives the
    same update bitwise while the data all-reduce carries the selected
    blocks only (r = 0.5 of the full-shape gradient's bytes)."""
    cases, res, _ = runs
    plain, cgr = cases["dense_scatter"], cases["dense_scatter_cgr"]
    for case in (plain, cgr):
        _check_metrics(case, res[case.name])
        _check_params(case, res[case.name])
    a, b = _gathered(plain, res[plain.name]), _gathered(cgr, res[cgr.name])
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert np.array_equal(x, y)
    full = res[plain.name][0]["steps"][0]["bytes"]
    comp = res[cgr.name][0]["steps"][0]["bytes"]
    assert "dw" not in full and "grad_full" not in comp
    assert comp["dw"] * 2 == full["grad_full"]
    assert comp["grad_dense"] == full["grad_dense"]


@pytest.mark.parametrize("name", ["moe_1x2", "moe_2x1"])
def test_moe_expert_and_data_parallel_match_the_reference(runs, name):
    """deepseek-moe smoke (8 routed experts, top-2, 2 shared), capacity
    factor 8 (no choice dropped, so the per-shard capacity cannot change
    the result): on (1, 2) each rank runs 4 experts, on (2, 1) each its
    data shard; losses and both auxiliary losses against the reference,
    and the params."""
    cases, res, _ = runs
    case = cases[name]
    _check_metrics(case, res[name], ("loss", "ce", "load_balance",
                                     "router_z"))
    _check_params(case, res[name])
    for r in res[name]:
        assert all(s["dropped"] == 0.0 for s in r["steps"])


def test_gemma_tied_vocab_parallel_head_on_1x2(runs):
    """gemma3-4b smoke on (1, 2): the tied embedding split over the vocab
    (the gather and the cross entropy vocab-parallel), local windows of
    16 in a 32-token sequence."""
    cases, res, _ = runs
    case = cases["gemma_1x2"]
    _check_metrics(case, res[case.name])
    _check_params(case, res[case.name])
    assert res[case.name][0]["steps"][0]["bytes"]["ce"] > 0


def test_bf16_mesh_run_within_loose_bounds(runs):
    """llama3-8b smoke in bf16 on (2, 2) from the reference's params
    rounded to bf16: losses within 2e-2 of the reference's f32 run."""
    cases, res, _ = runs
    ref = cases["llama_rules_for"]
    for r in res["bf16"]:
        for got, want in zip(r["steps"], ref.ref_rows):
            assert got["loss"] == pytest.approx(want["loss"], rel=2e-2)


def _check_selection(case, results):
    """Every rank's selection its shard of the reference's (the
    column-parallel leaves' shard axis split over `model`)."""
    for r in results:
        m = r["coords"]["model"]

        def walk(spec, want, got, path):
            if isinstance(spec, dict):
                for key in spec:
                    walk(spec[key], want[key], got[key], path + (key,))
                return
            want = np.asarray(want)
            if spec.n_shards > 1:
                n = spec.n_shards // case.shape[1]
                want = want[:, m * n:(m + 1) * n]
            np.testing.assert_array_equal(got, want, err_msg=str(path))
        for seg, spec in case.plan.spec.items():
            if case.sel.get(seg) is not None:
                walk(spec, case.sel[seg], r["sel_idx"][seg], (seg,))


@pytest.mark.parametrize("name", ["rwkv_1x2", "rwkv_2x2", "jamba_1x2",
                                  "jamba_2x2"])
def test_recurrent_families_on_a_mesh_match_the_reference(runs, name):
    """rwkv6-3b (the time mix whole, the WKV over every head on every
    rank; the channel mix d_ff-parallel) and jamba (mamba d_inner-parallel:
    in_proj's [x | z] columns split and gathered, x_proj and out_proj
    row-parallel; a paged attention layer and experts beside it) smoke on
    (1, 2) and (2, 2): 2 compact steps, losses and the gathered params
    against the reference's single-device step within 1e-5 (the one-device
    tests' bounds, `test_torch_rwkv_train`, `test_torch_jamba`),
    unselected and frozen blocks bitwise; on (1, 2) the ranks selected by
    magnitude on their shards, and each rank's selection is its shard of
    the reference's."""
    cases, res, _ = runs
    case = cases[name]
    assert len(res[name]) == case.shape[0] * case.shape[1]
    _check_metrics(case, res[name], ("loss", "ce", "load_balance",
                                     "router_z"))
    _check_params(case, res[name])
    if case.job["sel_idx"] is None:
        _check_selection(case, res[name])


def test_every_mamba_leaf_gradient_matches_the_reference(runs):
    """jamba on (1, 2), the first step's gradients after every reduction:
    the compact dW of in_proj (each rank its columns of [x | z]: the
    gather's backward sums over the ranks before the slice) and out_proj
    (each rank its rows), and the full gradients of the dense-rule leaves
    (x_proj: the rank's rows, its psum's backward summed; dt_proj, conv_w,
    conv_b, A_log, D, dt_bias: the rank's d_inner block), each against
    the rank's shard of the reference's: relative 1e-4 (the one-device
    mamba gradients' bound, `test_torch_mamba`: sums over the sequence in
    another order), absolute 1e-5 of the leaf's largest entry."""
    cases, res, _ = runs
    case = cases["jamba_1x2"]
    dense, compact = case.ref_grads
    fake = _fake(case.shape)
    rules = S.rules_for(fake, case.ptc.model, case.ptc.shape)
    logical = param_logical_specs(case.ptc.model)
    spec = case.plan.spec["blocks"]
    seen = set()
    for r in res["jamba_1x2"]:
        m = r["coords"]["model"]
        got_d = r["grads"]["dense"]["segments"]["blocks"]
        got_c = r["grads"]["compact"]["blocks"]
        want_d = S.shard_local(
            dense["segments"]["blocks"],
            S.tree_shardings(dense["segments"]["blocks"],
                             logical["segments"]["blocks"], rules),
            fake.shape, r["coords"])
        for sub in sorted(spec):
            if "mamba" not in spec[sub]:
                continue
            for name, g in got_d[sub]["mamba"].items():
                if g is None:
                    continue
                want = np.asarray(want_d[sub]["mamba"][name])
                assert g.shape == want.shape, (sub, name, g.shape)
                np.testing.assert_allclose(
                    g, want, rtol=1e-4,
                    atol=1e-5 * float(np.abs(want).max()),
                    err_msg=f"{sub} {name} rank {m}")
                seen.add(name)
            for name, sp in spec[sub]["mamba"].items():
                want = np.asarray(compact["blocks"][sub]["mamba"][name])
                if sp.n_shards > 1:                 # column-parallel
                    want = want[:, :, m:m + 1]
                else:                               # row-parallel
                    rows = want.shape[1] // 2
                    want = want[:, m * rows:(m + 1) * rows]
                g = np.asarray(got_c[sub]["mamba"][name])
                assert g.shape == want.shape, (sub, name, g.shape)
                np.testing.assert_allclose(
                    g, want, rtol=1e-4,
                    atol=1e-5 * float(np.abs(want).max()),
                    err_msg=f"{sub} {name} rank {m}")
                seen.add(name)
    assert seen == {"in_proj", "out_proj", "x_proj", "dt_proj", "conv_w",
                    "conv_b", "A_log", "D", "dt_bias"}, seen


def test_dynamic_phase_on_the_mesh_matches_the_reference(runs):
    """Through the dynamic phase the ranks draw the plan's fresh selection
    (the same on every rank) and keep their shards of it: losses and the
    gathered params against the reference's single-device step handed the
    same selections, and every rank's final selection its shard of the
    last one. The ranks drew their own params from the seed
    (`init_params(..., rules=)`) and selected by magnitude on their
    shards."""
    cases, res, _ = runs
    case = cases["dynamic"]
    assert len(res[case.name]) == 4
    assert any(not np.array_equal(a, b) for a, b in zip(
        jax.tree.leaves(case.sels[0]), jax.tree.leaves(case.sels[-1])))
    _check_metrics(case, res[case.name])
    _check_params(case, res[case.name])
    for r in res[case.name]:
        m = r["coords"]["model"]
        for sub in ("attn", "mlp"):
            for name, sp in case.plan.spec["blocks"][sub].items():
                want = np.asarray(case.sels[-1]["blocks"][sub][name])
                if sp.n_shards > 1:
                    want = want[:, m:m + 1]
                np.testing.assert_array_equal(r["sel_idx"]["blocks"][sub]
                                              [name], want, err_msg=name)


def test_collectives_and_their_backward_passes(runs):
    """On a 2-rank model axis, x = (m + 1) * [1, 2, 3] on rank m and the
    loss sum(y * w): copy_to_model is the identity forward and sums the
    gradient (2w); psum_mapped sums forward ([3, 6, 9]) and passes the
    gradient (w); all_gather_mapped concatenates in rank order and hands
    each rank its slice of the gradient."""
    _, res, _ = runs
    w = [1.0, 10.0, 100.0]
    assert len(res["collectives"]) == 2
    for r in res["collectives"]:
        m = r["coords"]["model"]
        x = [(m + 1) * v for v in (1.0, 2.0, 3.0)]
        assert r["copy"] == (x, [2 * v for v in w])
        assert r["psum"] == ([3.0, 6.0, 9.0], w)
        assert r["gather"] == ([1.0, 2.0, 3.0, 2.0, 4.0, 6.0], w)
        # copy's backward and psum's forward move 12 bytes each, the
        # gather 12 a rank
        assert r["bytes"] == {"act": 36}


def test_local_use_collectives_sum_the_gradient(runs):
    """The gather and the psum whose result each rank reads differently
    (mamba's in_proj gather and x_proj sum): rank m's loss is (m + 1) *
    sum(y * w), so each rank's gradient must be the sum of both ranks',
    3w, where the plain forms hand rank m (m + 1) w. Bytes: the gather's
    12 a rank plus its backward all-reduce of 24; the psum's 12 forward
    and 12 backward."""
    _, res, _ = runs
    w = [1.0, 10.0, 100.0]
    for r in res["collectives"]:
        assert r["gather_local"] == ([1.0, 2.0, 3.0, 2.0, 4.0, 6.0],
                                     [3 * v for v in w])
        assert r["psum_local"] == ([3.0, 6.0, 9.0], [3 * v for v in w])
        assert r["bytes_local"] == {"act": 12 + 24 + 12 + 12}


@pytest.mark.parametrize("arch", FAMILIES)
def test_every_attention_family_trains_on_a_mesh(runs, arch):
    """nemotron (layernorm, squared ReLU), command-r (tied vocab-parallel
    head), musicgen (embedding inputs, kv heads = query heads), qwen2-vl
    (M-RoPE under head sharding) and llama4-scout (MoE in every layer,
    capacity factor 8) on (2, 2): 2 compact steps from params the ranks
    drew from the seed and selected by magnitude on their shards; losses,
    the gathered params, unselected and frozen blocks against the
    reference's single-device step."""
    cases, res, _ = runs
    case = cases[arch]
    assert len(res[arch]) == 4
    _check_metrics(case, res[arch])
    _check_params(case, res[arch])
