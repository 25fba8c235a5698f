"""The port's launch tooling on one device against the reference's: the
abstract inputs, caches and train states of `launch/specs.py`, the `meta`
dry-run of `launch/dryrun.py`, and the full-gradient audit and launch
counts of `launch/trace_analysis.py` (the counterparts of
`launch/hlo_analysis.py`'s `weight_gradient_scatters` and
`kernel_launch_breakdown`)."""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")
from repro_torch.testing import limit_threads  # noqa: E402

limit_threads()
jax = pytest.importorskip("jax")

from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import SparseUpdateConfig as JSparse  # noqa: E402
from repro.configs import OptimizerConfig as JOpt  # noqa: E402
from repro.configs import TrainConfig as JTrain  # noqa: E402
from repro.configs import cell_is_skipped as jskipped  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.core import selection as jsel  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch.configs import (ARCH_IDS, SHAPES, OptimizerConfig,  # noqa: E402
                                 ShapeConfig, SparseUpdateConfig,
                                 TrainConfig, all_cells, get_config,
                                 get_smoke_config)
from repro_torch.core.sparse_update import tree_leaves  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import specs as pspecs  # noqa: E402
from repro_torch.launch import trace_analysis as TA  # noqa: E402
from repro_torch.models import mamba as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import make_train_state, make_train_step  # noqa: E402

LIVE = [(a, s) for a, s in all_cells() if jskipped(a, s) is None]
SMOKE_TRAIN = ShapeConfig("train_4k", 64, 2, "train")


def _flat(tree, prefix=""):
    """{path: (shape, dtype name)} of a nested dict of tensors or
    ShapeDtypeStructs; None leaves kept as None."""
    if tree is None:
        return {prefix: None}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    dt = tree.dtype
    name = str(dt).removeprefix("torch.") if isinstance(dt, torch.dtype) \
        else jax.numpy.dtype(dt).name
    return {prefix: (tuple(tree.shape), name)}


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

def test_input_specs_and_caches_match_reference():
    """Every cell the reference runs: the batch's keys, shapes and dtypes;
    a decode cell's stacked cache leaf for leaf (jax.eval_shape there,
    `meta` here)."""
    from repro.models import decoding as JD
    assert len(LIVE) == 33
    for arch, shape in LIVE:
        jcfg, pcfg = jget_config(arch), get_config(arch)
        want = _flat(jspecs.input_specs(jcfg, JSHAPES[shape]))
        assert _flat(pspecs.input_specs(pcfg, SHAPES[shape])) == want, \
            (arch, shape)
        if SHAPES[shape].kind == "decode":
            js = JSHAPES[shape]
            want = _flat(jax.eval_shape(
                lambda: JD.init_cache(jcfg, js.global_batch, js.seq_len)))
            got = _flat(pspecs.cache_abstract(pcfg, SHAPES[shape]))
            assert got == want, (arch, shape)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_train_state_matches_reference(arch):
    """The train state's tensors, leaf for leaf (params trainable and
    frozen, optimizer state, the selection), for a sparse AdamW and a
    dense SGD state of the smoke config. `step` and `rng` differ by design
    (a host int and an int seed against a 0-d array and a PRNG key)."""
    jcfg, pcfg = jget_smoke(arch), get_smoke_config(arch)
    k = pspecs._default_k(pcfg)
    assert k == jspecs._default_k(jcfg)
    for sp, opt in ((dict(update_ratio=0.2, num_update_layers=k,
                          channel_block=8), dict(kind="adamw")),
                    (dict(enabled=False), dict(kind="sgd"))):
        jtc = JTrain(model=jcfg, shape=JSHAPES["train_4k"],
                     sparse=JSparse(**sp), optimizer=JOpt(**opt))
        ptc = TrainConfig(model=pcfg, shape=SHAPES["train_4k"],
                          sparse=SparseUpdateConfig(**sp),
                          optimizer=OptimizerConfig(**opt))
        want = jax.eval_shape(lambda key: jsteps.make_train_state(
            jtc, key, selection_init="random")[0], jax.random.PRNGKey(0))
        got, _ = make_train_state(ptc, selection_init="random",
                                  device="meta")
        for key in ("params_trainable", "params_frozen", "opt", "sel_idx"):
            assert _flat(got[key]) == _flat(want[key]), (arch, sp, key)


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_run_cell_smoke_train_matches_reference_plan(arch):
    """A smoke train cell on `meta` is OK in both modes; its selected
    fraction and trainable steps are the reference's `build_plan` values
    for the same sparse config; the dense state trains every step."""
    jcfg, pcfg = jget_smoke(arch), get_smoke_config(arch)
    rec = dryrun.run_cell(arch, "train_4k", "sparse", model=pcfg,
                          shape=SMOKE_TRAIN)
    assert rec["status"] == "OK" and rec["mesh"] == "1"
    k = jspecs._default_k(jcfg)
    jplan = jsel.build_plan(jcfg, JSparse(update_ratio=0.2,
                                          num_update_layers=k,
                                          channel_block=128),
                            SMOKE_TRAIN.global_batch * SMOKE_TRAIN.seq_len)
    assert rec["selected_param_fraction"] == pytest.approx(
        jsel.selected_fraction(jplan, jcfg), rel=1e-12)
    assert rec["trainable_scan_steps"] == sum(jplan.seg_trainable.values())
    dense = dryrun.run_cell(arch, "train_4k", "dense", model=pcfg,
                            shape=SMOKE_TRAIN)
    assert dense["status"] == "OK"
    assert dense["flops"] > 0 and rec["flops"] > 0
    assert rec["bytes"]["sel_idx"] > 0 and dense["bytes"]["sel_idx"] == 0
    assert dense["bytes"]["params_frozen"] + dense["bytes"][
        "params_trainable"] == rec["bytes"]["params_frozen"] + \
        rec["bytes"]["params_trainable"]
    assert dense["bytes"]["params_trainable"] >= \
        rec["bytes"]["params_trainable"] > 0


@pytest.mark.parametrize("arch", ["llama3-8b", "gemma3-4b", "rwkv6-3b",
                                  "jamba-1.5-large-398b", "qwen2-vl-7b"])
def test_run_cell_smoke_serving_cells(arch):
    """Smoke prefill and decode cells on `meta`: OK, a cache, FLOPs, and
    they fit."""
    cfg = get_smoke_config(arch)
    for name, shape in (("prefill_32k", ShapeConfig("prefill_32k", 64, 2,
                                                    "prefill")),
                        ("decode_32k", ShapeConfig("decode_32k", 64, 2,
                                                   "decode"))):
        rec = dryrun.run_cell(arch, name, model=cfg, shape=shape)
        assert rec["status"] == "OK", rec
        assert rec["bytes"]["cache"] > 0 and rec["flops"] > 0
        assert rec["fits_one_h100"] and rec["device_bytes_assumed"]


def test_run_cell_skips_with_the_reference_reason():
    for arch, shape in all_cells():
        rec = dryrun.run_cell(arch, shape) if jskipped(arch, shape) \
            else None
        if rec is not None:
            assert rec["status"] == "SKIP"
            assert rec["skip_reason"] == jskipped(arch, shape)


def test_full_size_train_cell_on_meta():
    """A published config at its published cell costs nothing on `meta`:
    gemma3-4b train_4k (batch 256 x 4096) in both modes, its analytic
    extra the memory model's."""
    from repro_torch.core import memory as pmem
    cfg = get_config("gemma3-4b")
    sparse = dryrun.run_cell("gemma3-4b", "train_4k", "sparse")
    dense = dryrun.run_cell("gemma3-4b", "train_4k", "dense")
    tokens = 256 * 4096
    k = pspecs._default_k(cfg)
    assert sparse["analytic_extra_bytes"] == pmem.training_extra_bytes(
        cfg, SparseUpdateConfig(update_ratio=0.2, num_update_layers=k,
                                channel_block=128), k, tokens, 0)
    assert dense["analytic_extra_bytes"] == \
        pmem.dense_training_extra_bytes(cfg, tokens, 0)
    assert dense["flops"] > sparse["flops"] > 0
    assert sparse["bytes"]["batch"] == 2 * tokens * 4


def test_dryrun_cli_writes_one_json_a_cell(tmp_path, capsys):
    dryrun.main(["--arch", "llama3-8b", "--shape", "long_500k", "--out",
                 str(tmp_path)])
    rec = json.loads((tmp_path / "llama3-8b__long_500k__1__sparse.json")
                     .read_text())
    assert rec["status"] == "SKIP"
    assert "SKIP" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# FLOPs
# ---------------------------------------------------------------------------

def test_flop_count_of_a_dense_forward_is_its_products():
    """FlopCounterMode on a llama3-8b smoke forward (B = 2, S = 24, fp32)
    against a hand count of its products, 2 x M x K x N each: per layer q
    (d -> H hd), k and v (d -> Hkv hd), o (H hd -> d), the scores and the
    probabilities times values (B H S S hd each: dense attention computes
    the full square and masks it), and the SwiGLU MLP's three (d <-> d_ff)."""
    cfg = get_smoke_config("llama3-8b")
    b, s = 2, 24
    m, d, h, hkv, hd, ff = (b * s, cfg.d_model, cfg.num_heads,
                            cfg.num_kv_heads, cfg.resolved_head_dim, cfg.d_ff)
    per_layer = (2 * m * d * h * hd + 2 * 2 * m * d * hkv * hd
                 + 2 * m * h * hd * d + 2 * 2 * b * h * s * s * hd
                 + 3 * 2 * m * d * ff)
    params = T.init_params(cfg, 0, "cpu")
    batch = {"tokens": torch.zeros((b, s), dtype=torch.int32)}
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        T.forward(cfg, (params, None), batch)
    assert counter.get_total_flops() == cfg.num_layers * per_layer


def test_meta_recurrences_count_the_step_loops_flops():
    """The `meta` forms of the WKV recurrence (forward and backward) and of
    the mamba scan give the step / chunk loops' shapes and FLOP counts."""
    g = torch.Generator().manual_seed(0)

    def count(fn):
        with FlopCounterMode(display=False) as counter:
            out = fn()
        return counter.get_total_flops(), out

    b, t, h, d = 2, 12, 3, 8
    cpu = [torch.rand((b, t, h, d), generator=g) for _ in range(5)] + \
        [torch.rand((h, d), generator=g)]
    meta = [x.to("meta") for x in cpu]
    for fn in (lambda r, k, v, w, dy, u: ops.wkv6_fwd(r, k, v, w, u),
               lambda r, k, v, w, dy, u: ops.wkv6_fwd(
                   r, k, v, w, u, want_state=True),
               lambda r, k, v, w, dy, u: ops.wkv6_bwd(r, k, v, w, u, dy)):
        n_cpu, out_cpu = count(lambda: fn(*cpu))
        n_meta, out_meta = count(lambda: fn(*meta))
        assert n_meta == n_cpu > 0
        outs = [out_cpu] if torch.is_tensor(out_cpu) else list(out_cpu)
        outs_m = [out_meta] if torch.is_tensor(out_meta) else list(out_meta)
        assert [(o.shape, o.dtype) for o in outs] == \
            [(o.shape, o.dtype) for o in outs_m]

    dm, n, s = 6, 4, 3 * M.CHUNK
    args = [-torch.rand((dm, n), generator=g),
            torch.rand((b, s, dm), generator=g),
            torch.rand((b, s, dm), generator=g),
            torch.rand((b, s, n), generator=g),
            torch.rand((b, s, n), generator=g), torch.zeros((b, dm, n))]
    got = []
    for device in ("cpu", "meta"):
        a = [x.to(device).requires_grad_(x.dim() == 3) for x in args]

        def scan():
            y, h_last = M.selective_scan(*a)
            torch.autograd.grad(y.sum() + h_last.sum(), a[1:5])
            return y, h_last
        flops, (y, h_last) = count(scan)
        got.append((flops, y.shape, h_last.shape))
    assert got[0] == got[1] and got[0][0] > 0


# ---------------------------------------------------------------------------
# the audits
# ---------------------------------------------------------------------------

def _audited_step(arch: str, mode: str):
    """One fp32 smoke step (r = 0.4, blocks of 8, K = 2, SGD) under the
    full-gradient audit: compact, dense-scatter or dense. 2 x 24 tokens:
    no weight dim, and no compact layout one leaf shares with another's
    blocked layout (the shape test's blind spots at smoke widths). rwkv6
    at d_model 96: at the smoke config's 64 its decay LoRA (wA [d, 64],
    wB [64, d], outside the selection, so dense by design) has the shape of
    the selectable mixing weights, as it has not at full width (2560)."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    if arch == "rwkv6-3b":
        cfg = dataclasses.replace(cfg, d_model=96, num_heads=6)
    sp = SparseUpdateConfig(update_ratio=0.4, num_update_layers=2,
                            channel_block=8, enabled=mode != "dense")
    tc = TrainConfig(model=cfg, shape=ShapeConfig("s", 24, 2, "train"),
                     sparse=sp, optimizer=OptimizerConfig(kind="sgd"),
                     compact_grads=mode == "compact")
    state, plan = make_train_state(tc, device="cpu")
    gen = torch.Generator().manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 24), generator=gen,
                              dtype=torch.int32)
             for k in ("tokens", "labels")}
    weights = TA.selectable_weights(plan, state["params_trainable"])
    step = make_train_step(tc, plan)
    _, audit = TA.full_gradient_audit(
        lambda: step(state, batch), weights,
        tree_leaves(state["params_frozen"])
        + tree_leaves(state["params_trainable"]))
    return weights, audit, plan, cfg


@pytest.mark.parametrize("arch", ["llama3-8b", "deepseek-moe-16b",
                                  "rwkv6-3b", "gemma3-4b"])
def test_compact_step_materializes_no_full_weight_gradient(arch):
    """The counterpart of test_compact_hlo_has_no_full_gradient_scatter:
    the compact step's backward builds no tensor of a selectable weight's
    full (or blocked) shape; the dense-scatter step's builds at least one
    per selectable leaf, in the backward."""
    weights, audit, _, _ = _audited_step(arch, "compact")
    assert audit.backward_ops > 0
    assert TA.weight_gradient_tensors(audit) == []
    weights, audit, _, _ = _audited_step(arch, "dense_scatter")
    grads = TA.weight_gradient_tensors(audit)
    counts = TA.per_leaf_counts(grads, weights)
    assert len(weights) > 0 and min(counts.values()) >= 1, counts


def test_audit_sees_a_dense_steps_gradients_and_refuses_meta():
    weights, audit, _, _ = _audited_step("llama3-8b", "dense")
    counts = TA.per_leaf_counts(TA.weight_gradient_tensors(audit), weights)
    assert min(counts.values()) >= 1
    meta = {k: (w.to("meta"), sp) for k, (w, sp) in weights.items()}
    with pytest.raises(ValueError):
        TA.FullGradientAudit(meta)


@pytest.mark.parametrize("arch,want", [
    ("llama3-8b", {"block_sparse_dw": 14, "fused_block_opt": 7}),
    ("deepseek-moe-16b", {"block_sparse_dw": 14, "batched_dw": 6,
                          "fused_block_opt": 10}),
])
def test_plan_launches_and_the_cpu_step_launches_nothing(arch, want):
    """Launches per compact step from the plan (the dW once per leaf and
    trainable step, the optimizer once per leaf: constant per leaf, as the
    reference's site count); on the CPU every wrapper runs its plain
    version and `launch_breakdown` reads no launch."""
    cfg = get_smoke_config(arch)
    sp = SparseUpdateConfig(update_ratio=0.4, num_update_layers=2,
                            channel_block=8)
    tc = TrainConfig(model=cfg, shape=ShapeConfig("s", 24, 2, "train"),
                     sparse=sp, optimizer=OptimizerConfig(kind="sgd"),
                     compact_grads=True)
    state, plan = make_train_state(tc, device="cpu")
    expected = {k: 0 for k in ops.LAUNCHES}
    expected.update(want)
    assert TA.plan_launches(cfg, plan) == expected
    assert TA.plan_leaf_count(plan) == want["fused_block_opt"]
    batch = {k: torch.zeros((2, 24), dtype=torch.int32)
             for k in ("tokens", "labels")}
    _, launched = TA.launch_breakdown(
        lambda: make_train_step(tc, plan)(state, batch))
    assert launched == {k: 0 for k in ops.LAUNCHES}
