"""The port's sharding rules against the reference's, with no processes:
the logical spec of every param leaf (every arch, smoke and published
configs), `resolve_pspec`'s cases, `default_rules` / `seq_sharded_rules` /
`rules_for` for every shape, `model_axis_size` without a mesh, and the
selection plans `build_plan` gives under fake (1, 2), (2, 2) and (1, 4)
meshes, both rule sets. A fake mesh is an object with a `shape` dict, as
the reference's own test builds it."""
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from repro.configs import ARCH_IDS, SHAPES, ShapeConfig, SparseUpdateConfig
from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.core.selection import build_plan as jbuild_plan
from repro.launch.specs import resolve_pspec as jresolve
from repro.launch.specs import rules_for as jrules_for
from repro.models.specs import param_logical_specs as jspecs
from repro.sharding import default_rules as jdefault
from repro.sharding import seq_sharded_rules as jseq
from repro.sharding import use_rules as juse

from repro_torch import sharding as SH
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.selection import build_plan
from repro_torch.launch import specs as S
from repro_torch.models.specs import param_logical_specs
from repro_torch.models.registry import abstract_params
from repro_torch.testing import limit_threads

limit_threads()

MESHES = [(1, 2), (2, 2), (1, 4)]


def _fake(n_data: int, n_model: int, pod: int = 0):
    shape = {"data": n_data, "model": n_model}
    if pod:
        shape = {"pod": pod, **shape}
    return SimpleNamespace(shape=shape, axis_names=tuple(shape))


def _norm(rules: dict) -> dict:
    """Rule values as tuples of axes (or None), as both packages mean
    them."""
    out = {}
    for k, v in rules.items():
        out[k] = None if v is None else ((v,) if isinstance(v, str)
                                         else tuple(v))
    return out


@pytest.mark.parametrize("kind", ["smoke", "published"])
def test_param_logical_specs_match_the_reference(kind):
    for arch in ARCH_IDS:
        cfg = get_smoke_config(arch) if kind == "smoke" else get_config(arch)
        jcfg = jget_smoke(arch) if kind == "smoke" else jget_config(arch)
        got, want = param_logical_specs(cfg), jspecs(jcfg)
        assert got == want, arch
        if kind == "published":
            continue
        # every leaf of the port's tree has a spec of its rank
        flat = jax.tree_util.tree_leaves_with_path(
            abstract_params(cfg), is_leaf=lambda t: hasattr(t, "shape"))
        for path, leaf in flat:
            node = got
            for p in path:
                node = node[p.key]
            assert len(node) == leaf.dim(), (arch, path)


def test_resolve_pspec_divisibility_fallback_as_the_reference():
    cases = [((10, 7), ("batch", "ff")), ((10, 8), ("batch", "ff")),
             ((10, 7), (None, "nope")), ((16, 6), ("vocab", "heads")),
             ((12, 8, 4), ("batch", "expert", "kv_heads"))]
    for mesh in [_fake(1, 1), _fake(2, 4), _fake(2, 2, pod=2), _fake(3, 2)]:
        port, ref = SH.default_rules(mesh), jdefault(mesh)
        for shape, logical in cases:
            assert S.resolve_pspec(shape, logical, port) == \
                _axes(jresolve(shape, logical, ref)), (mesh.shape, shape)
    # the reference's own: 7 % 4 != 0 -> the ff dim falls back to None
    big = SH.AxisRules(dict(SH.default_rules(_fake(1, 1)).rules),
                       mesh=SimpleNamespace(shape={"data": 2, "model": 4}),
                       batch_axes=("data",), model_axis="model")
    assert S.resolve_pspec((10, 7), ("batch", "ff"), big) == (("data",),
                                                               None)
    assert S.resolve_pspec((10, 8), ("batch", "ff"), big) == (("data",),
                                                               ("model",))


def test_rules_match_the_reference_for_every_shape():
    for mesh in [_fake(2, 2), _fake(16, 16), _fake(16, 16, pod=2)]:
        for port, ref in [(SH.default_rules(mesh), jdefault(mesh)),
                          (SH.seq_sharded_rules(mesh), jseq(mesh))]:
            assert _norm(port.rules) == _norm(ref.rules)
            assert tuple(port.batch_axes) == tuple(ref.batch_axes)
            assert port.model_axis == ref.model_axis
        cfg, jcfg = get_smoke_config("llama3-8b"), jget_smoke("llama3-8b")
        for shape in SHAPES.values():
            port, ref = S.rules_for(mesh, cfg, shape), \
                jrules_for(mesh, jcfg, shape)
            assert _norm(port.rules) == _norm(ref.rules), shape.name
            assert tuple(port.batch_axes) == tuple(ref.batch_axes)
    long = S.rules_for(_fake(1, 1), cfg, SHAPES["long_500k"])
    assert long.rules["batch"] is None and long.rules["kv_heads"] is None
    assert tuple(long.rules["cache_seq"]) == ("data", "model")


def test_model_axis_size_raises_without_a_mesh():
    rules = SH.AxisRules({"heads": "model"}, mesh=None, model_axis="model")
    with SH.use_rules(rules):
        with pytest.raises(ValueError, match="carry no mesh"):
            SH.model_axis_size()
    assert SH.model_axis_size() == 1                # no rules at all
    with SH.use_rules(SH.default_rules(_fake(2, 4))):
        assert SH.model_axis_size() == 4
        assert SH.logical_spec("batch", "heads", None) == (("data",),
                                                           "model", None)
        # a fake mesh has no process groups: the model code stays local
        assert SH.process_mesh() is None and SH.model_group() is None


def _axes(spec) -> tuple:
    """A sharding as per-dim tuples of axes (or None): the reference's
    PartitionSpec writes a one-axis entry as the bare name."""
    return tuple(None if e is None else ((e,) if isinstance(e, str)
                                         else tuple(e)) for e in spec)


def _plan_specs(spec):
    if isinstance(spec, dict):
        return {k: _plan_specs(v) for k, v in spec.items()}
    return tuple(spec)


@pytest.mark.parametrize("mesh", MESHES, ids=[f"{d}x{m}" for d, m in MESHES])
def test_build_plan_specs_match_the_reference_under_fake_meshes(mesh):
    sp = SparseUpdateConfig(update_ratio=0.25, num_update_layers=2,
                            channel_block=8)
    fake = _fake(*mesh)
    shape = ShapeConfig("t", 32, 4, "train")
    for arch in ARCH_IDS:
        cfg, jcfg = get_smoke_config(arch), jget_smoke(arch)
        for port, ref in [(SH.default_rules(fake), jdefault(fake)),
                          (S.rules_for(fake, cfg, shape),
                           jrules_for(fake, jcfg, shape))]:
            with SH.use_rules(port):
                got = build_plan(cfg, sp)
            with juse(ref):
                want = jbuild_plan(jcfg, sp)
            assert _plan_specs(got.spec) == _plan_specs(want.spec), \
                (arch, mesh)
            assert got.seg_trainable == want.seg_trainable


def test_llama_plan_n_shards_under_a_two_way_model_axis():
    """The numbers of the reference's plan for llama3-8b smoke, model axis
    2: default_rules splits wq, wk, wv, w_gate, w_up; rules_for keeps the
    kv heads whole (kv_heads -> None), so wk / wv take one shard."""
    cfg = get_smoke_config("llama3-8b")
    sp = SparseUpdateConfig(update_ratio=0.5, num_update_layers=1,
                            channel_block=8)
    fake = _fake(1, 2)
    with SH.use_rules(SH.default_rules(fake)):
        d = build_plan(cfg, sp).spec["blocks"]
    with SH.use_rules(S.rules_for(fake, cfg, ShapeConfig("t", 16, 2,
                                                         "train"))):
        r = build_plan(cfg, sp).spec["blocks"]
    shards = lambda s: {k: v.n_shards for k, v in {**s["attn"],
                                                   **s["mlp"]}.items()}
    assert shards(d) == {"wq": 2, "wk": 2, "wv": 2, "wo": 1, "w_gate": 2,
                         "w_up": 2, "w_down": 1}
    assert shards(r) == {"wq": 2, "wk": 1, "wv": 1, "wo": 1, "w_gate": 2,
                         "w_up": 2, "w_down": 1}


def test_shardings_cut_and_reassemble_a_param_tree():
    """tree_shardings against the reference's resolve_pspec leaf for leaf
    (the shapes of the port's tree, the reference's logical specs);
    shard_local then gather_shards gives the whole tree back, and a rank's
    slice has the shape its sharding says."""
    from repro_torch import bridge
    from repro_torch.models import transformer as T

    fake = _fake(2, 2)
    shape = ShapeConfig("t", 16, 4, "train")
    for arch in ("llama3-8b", "deepseek-moe-16b", "gemma3-4b"):
        cfg, jcfg = get_smoke_config(arch), jget_smoke(arch)
        rules, ref = S.rules_for(fake, cfg, shape), \
            jrules_for(fake, jcfg, shape)
        full = bridge.to_numpy(T.init_params(cfg, 0, "cpu"))
        sh = S.tree_shardings(full, param_logical_specs(cfg), rules)
        logical = jspecs(jcfg)
        for path, leaf in jax.tree_util.tree_leaves_with_path(full):
            node, lg = sh, logical
            for p in path:
                node, lg = node[p.key], lg[p.key]
            assert node == _axes(jresolve(leaf.shape, lg, ref)), path
        coords = [{"data": d, "model": m} for d in range(2)
                  for m in range(2)]
        parts = [S.shard_local(full, sh, fake.shape, c) for c in coords]
        back = S.gather_shards(parts, coords, sh, fake.shape)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(full)):
            np.testing.assert_array_equal(a, b)
        last = parts[1]["segments"]["blocks"]
        attn = last["attn"] if "attn" in last else last["sub0"]["attn"]
        assert attn["wq"].shape[-1] == \
            cfg.num_heads * cfg.resolved_head_dim // 2


def test_state_shardings_follow_the_params_and_the_plan():
    """A train state's shardings: params and optimizer state by their
    leaves' logical axes (as tree_shardings), the selection's shard axis
    over `model` exactly where the plan splits a weight's out dim."""
    from repro_torch.configs import (OptimizerConfig, SparseUpdateConfig,
                                     TrainConfig)
    from repro_torch.train import make_train_state

    cfg = get_smoke_config("llama3-8b")
    shape = ShapeConfig("t", 16, 4, "train")
    tc = TrainConfig(model=cfg, shape=shape,
                     sparse=SparseUpdateConfig(num_update_layers=2,
                                               channel_block=8),
                     optimizer=OptimizerConfig(kind="adamw"))
    rules = S.rules_for(_fake(2, 2), cfg, shape)
    with SH.use_rules(rules):
        state, plan = make_train_state(tc, selection_init="random",
                                       device="meta")
    sh = S.state_shardings(cfg, plan, state, rules)
    logical = param_logical_specs(cfg)
    assert sh["params_frozen"] == S.tree_shardings(state["params_frozen"],
                                                   logical, rules)
    assert sh["opt"]["mu"] == sh["opt"]["nu"] == sh["params_trainable"]
    attn = sh["params_trainable"]["segments"]["blocks"]["attn"]
    assert attn["wq"] == (None, None, ("model",))
    assert attn["wk"] == (None, None, None)           # kv heads whole
    assert attn["wo"] == (None, ("model",), None)
    sel = sh["sel_idx"]["blocks"]
    assert sel["attn"]["wq"] == (None, ("model",), None)
    assert sel["attn"]["wk"] == sel["attn"]["wo"] == (None, None, None)
    assert sh["params_frozen"]["embed"]["tok"] == (("model",), None)
    assert S.batch_shardings(cfg, shape, rules) == {
        "tokens": (("data",), None), "labels": (("data",), None)}


def test_production_mesh_refuses_another_world():
    from repro_torch.launch.mesh import make_production_mesh
    for multi_pod, n in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=f"world of {n} ranks"):
            make_production_mesh(multi_pod=multi_pod)
