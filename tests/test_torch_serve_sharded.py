"""The port's sharded paged serving (a (1, n) process mesh over `model`,
`launch.mesh_serve`) against the reference's single-device engine, on the
CPU.

One world of 4 gloo ranks is spawned for the module and runs every mesh
case (`mesh_serve.run_jobs`; an n = 2 case uses the first 2 ranks); this
process computes the reference meanwhile, once per workload, from the same
params (the port's draw, as numpy). The cases, as the reference's own
sharded test has them: llama3-8b (Hq 8, Hkv 4), gemma3-4b (ring + paged),
rwkv6-3b (the time mix by head block, the channel mix by d_ff, the
recurrent state sliced and gathered back), jamba (Hq 8, Hkv 4: mamba by
d_inner beside a paged attention layer and d_ff-parallel experts) and
deepseek-moe-16b (d_ff-parallel experts with shared experts) smoke
configs at n = 2 and 4, each serving the shared-prefix workload twice on
one engine (run 2 rehydrates its prefix pages or state snapshots from the
spill tier), and the personalized mix (a repeat user whose train wave
lands mid-run; the reference's per-user selection carried over). Tokens
and page accounting are compared exactly, in f32 (the one-device serving
tests' bound, `test_torch_serve_families`: greedy tokens equal); every
sampled step's top-2 logit gap is probed and a gap under 1e-4 fails
loudly. Also: the spec trees against the reference's under fake meshes,
the rejection paths, the replication audit, rwkv with a head count the
mesh does not divide (its time mix whole, its channel mix sharded), a
spill tier persisted at one mesh width and restored at another, and a rank
whose decisions part from the others' failing the run."""
import concurrent.futures
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from repro_torch.testing import TEST_THREADS, limit_threads  # noqa: E402

limit_threads()
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import sharding as JSH  # noqa: E402
from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import OptimizerConfig as JOpt  # noqa: E402
from repro.configs import SparseUpdateConfig as JSparse  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import decoding as JD  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve import PersonalizationConfig as JP13n  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro.serve.engine import make_shared_prefix_requests as jshared  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch import sharding as SH  # noqa: E402
from repro_torch.configs import OptimizerConfig, SparseUpdateConfig  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.launch import mesh, mesh_serve  # noqa: E402
from repro_torch.launch import specs as S  # noqa: E402
from repro_torch.launch.mesh import make_serve_mesh  # noqa: E402
from repro_torch.models import decoding as D  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.models.registry import abstract_params  # noqa: E402
from repro_torch.serve import PersonalizationConfig, ServeEngine  # noqa: E402
from repro_torch.serve import make_shared_prefix_requests  # noqa: E402

WORLD = 4
PAGE = 4
PREFIX = 8       # two full pages: snapshots and shared pages on the boundary
PROMPT = 11      # 2 full pages + a 3-row partial: chunks cross boundaries
GEN = 4
MAXLEN = 16
ENGINE = dict(num_slots=2, max_len=MAXLEN, page_size=PAGE, num_pages=16)
ARCHS = ("llama3-8b", "gemma3-4b", "rwkv6-3b", "jamba-1.5-large-398b",
         "deepseek-moe-16b")
WIDTHS = (2, 4)
GAP = 1e-4
USER = 7


def _cfgs(arch, **kw):
    """(reference, port) smoke configs; an attention arch with 8 query and
    4 kv heads, so a 4-way mesh splits them (the reference test's
    setting). `kw` replaces more fields."""
    j, p = jget_smoke(arch), get_smoke_config(arch)
    if p.num_heads:
        kw = dict(num_heads=8, num_kv_heads=4, **kw)
    return dataclasses.replace(j, **kw), dataclasses.replace(p, **kw)


# rwkv6 with 3 heads of 16: a 2-way mesh cannot split its time mix, so its
# matrices stay whole (the one-device path) while the channel mix (d_ff
# 128) and the vocabulary split
ODD_RWKV = dict(d_model=48)


def _params(pcfg):
    return bridge.to_numpy(PT.init_params(pcfg, 0, "cpu"))


def _jparams(params):
    return jax.tree.map(jnp.asarray, params)


def _runs(cfg, n_req, seed, user=False):
    reqs = make_shared_prefix_requests(cfg, n_req, PREFIX, PROMPT, GEN,
                                       seed=seed)
    if user:
        for r in reqs[::2]:
            r.user = USER     # the same user twice: a wave lands mid-run
    return reqs


def _jruns(cfg, n_req, seed, user=False):
    reqs = jshared(cfg, n_req, PREFIX, PROMPT, GEN, seed=seed)
    if user:
        for r in reqs[::2]:
            r.user = USER
    return reqs


def _tokens(stats):
    return {r.rid: list(r.tokens) for r in stats.results.values()}


def _account(stats):
    return {k: getattr(stats, k) for k in mesh_serve.ACCOUNT}


def _p13n(C, P):
    return P(sparse=C[1](update_ratio=0.5, num_update_layers=2,
                         channel_block=8),
             optimizer=C[0](kind="sgd", learning_rate=0.05),
             train_tokens=8)


def _fake_rules(n, R=SH):
    m = types.SimpleNamespace(shape={"data": 1, "model": n},
                              axis_names=("data", "model"))
    return R.AxisRules({"paged_pool": "model"}, mesh=m, model_axis="model")


class _World:
    """The module's jobs, the ranks' results by job name, and the
    reference's runs by workload."""

    def __init__(self, tmp):
        self.jobs, self.ref = [], {}
        self.cfgs = {a: _cfgs(a) for a in ARCHS}
        self.params = {a: _params(self.cfgs[a][1]) for a in ARCHS}
        for arch in ARCHS:
            pcfg = self.cfgs[arch][1]
            for n in WIDTHS:
                self.jobs.append(dict(
                    name=f"{arch}-{n}", cfg=pcfg, n=n,
                    params=self.params[arch], engine=ENGINE, gaps=True,
                    runs=[_runs(pcfg, 3, 3), _runs(pcfg, 3, 3)]))
        jcfg, pcfg = self.cfgs["llama3-8b"]
        # the reference's first delta of USER (jax.random), carried over
        self._jp13n = JServeEngine(
            jcfg, _jparams(self.params["llama3-8b"]),
            personalization=_p13n((JOpt, JSparse), JP13n), **ENGINE)
        first = self._jp13n._make_delta_entry(USER)
        deltas = {USER: {"idx": jax.tree.map(np.asarray, first.idx),
                         "vals": jax.tree.map(np.asarray, first.vals)}}
        for n in WIDTHS:
            self.jobs.append(dict(
                name=f"p13n-{n}", cfg=pcfg, n=n,
                params=self.params["llama3-8b"], engine=dict(
                    ENGINE, personalization=_p13n(
                        (OptimizerConfig, SparseUpdateConfig),
                        PersonalizationConfig)),
                deltas=deltas, gaps=True, runs=[_runs(pcfg, 4, 5, True)]))
        # the audit: d_ff = 96, so the MLP's full shapes collide with no
        # attention shard (the reference test's setting)
        acfg = dataclasses.replace(get_smoke_config("llama3-8b"), d_ff=96)
        self.jobs.append(dict(name="audit", kind="audit", cfg=acfg, n=2,
                              params=_params(acfg),
                              engine=dict(ENGINE, num_slots=2)))
        self.cfgs["odd-rwkv"] = _cfgs("rwkv6-3b", **ODD_RWKV)
        self.params["odd-rwkv"] = _params(self.cfgs["odd-rwkv"][1])
        self.jobs.append(dict(name="odd-rwkv", cfg=self.cfgs["odd-rwkv"][1],
                              n=2, params=self.params["odd-rwkv"],
                              engine=ENGINE, gaps=True,
                              runs=[_runs(self.cfgs["odd-rwkv"][1], 3, 3)]))
        # a spill tier persisted by 2 ranks, restored by one process, which
        # persists it again for 4 ranks
        persist = dict(ENGINE, prefix_persist=str(tmp / "tier"))
        for i, n in enumerate((2, 1, 4)):
            self.jobs.append(dict(name=f"persist-{i}", cfg=pcfg, n=n,
                                  params=self.params["llama3-8b"],
                                  engine=persist, runs=[_runs(pcfg, 3, 3)]))
        # rank 1 samples where rank 0 takes the argmax: its next step's
        # inputs part from rank 0's, and every rank must fail, none hang
        self.jobs.append(dict(name="out-of-step", cfg=pcfg, n=2,
                              params=self.params["llama3-8b"],
                              engine=dict(ENGINE, prefix_mode="off"),
                              rank_engine={1: {"temperature": 1.0}},
                              runs=[_runs(pcfg, 3, 3)],
                              expect_raise=RuntimeError))
        self.ranks = None

    def spawn(self):
        return mesh.spawn(mesh_serve.run_jobs, WORLD, args=(self.jobs,),
                          timeout_s=120)

    def reference(self):
        for arch in ARCHS:
            jcfg, _ = self.cfgs[arch]
            eng = JServeEngine(jcfg, _jparams(self.params[arch]), **ENGINE)
            self.ref[arch] = [eng.run(_jruns(jcfg, 3, 3)),
                              eng.run(_jruns(jcfg, 3, 3))]
            self.ref[arch + "/in_use"] = eng._pool.in_use
        jcfg = self.cfgs["llama3-8b"][0]
        self.ref["p13n"] = self._jp13n.run(_jruns(jcfg, 4, 5, True))
        jcfg = self.cfgs["odd-rwkv"][0]
        eng = JServeEngine(jcfg, _jparams(self.params["odd-rwkv"]), **ENGINE)
        self.ref["odd-rwkv"] = eng.run(_jruns(jcfg, 3, 3))

    def results(self, name):
        i = next(i for i, j in enumerate(self.jobs) if j["name"] == name)
        return [r[i] for r in self.ranks if r[i] is not None]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = _World(tmp_path_factory.mktemp("serve_sharded"))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(w.spawn)
        w.reference()
        w.ranks = ranks.result()
    return w


# ---------------------------------------------------------------------------
# the mesh cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_engine_matches_reference(world, arch, n):
    """Both runs of the shared-prefix workload: every rank's tokens and
    page accounting equal the reference's single-device engine's, run 2
    rehydrates onto the sharded pool (rwkv: its state snapshots), the
    radix tree keeps the reference's resident pages, and each rank's pool
    holds 1/n of the pool's bytes (rwkv has no pool)."""
    ranks = world.results(f"{arch}-{n}")
    assert len(ranks) == n
    pcfg = world.cfgs[arch][1]
    pool_bytes = sum(
        a.numel() * a.element_size()
        for seg in D.init_serve_cache(pcfg, 2, MAXLEN, 16,
                                      PAGE, device="meta")[1].values()
        for a in _leaves(seg))
    assert (pool_bytes > 0) == D.has_paged_layers(pcfg)
    for r in ranks:
        assert r["min_gap"] > GAP, f"near tie: top-2 gap {r['min_gap']}"
        for got, want in zip(r["runs"], world.ref[arch]):
            assert got["tokens"] == _tokens(want)
            assert got["account"] == _account(want)
            assert got["mesh_shards"] == n
            assert got["pool_shard_bytes"] * n == pool_bytes
        assert r["runs"][1]["account"]["rehydrates"] > 0
        assert r["runs"][-1]["in_use"] == world.ref[arch + "/in_use"]
    if arch == "llama3-8b":
        assert world.ref[arch][0].cow_splits > 0
    if D.has_state_layers(pcfg):
        assert world.ref[arch][0].snapshot_hits > 0
        # the ring layers' heads and the recurrent layers' state are
        # gathered back whole every step
        assert ranks[0]["runs"][0]["bytes"]["state"] > 0


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("n", WIDTHS)
def test_personalized_sharded_engine_matches_reference(world, n):
    """The personalized mix: tokens, train waves and wave losses equal the
    reference's single-device engine's (every rank trains each wave on the
    whole params, so the deltas are mesh-width independent)."""
    ref = world.ref["p13n"]
    assert ref.train_waves > 0
    ranks = world.results(f"p13n-{n}")
    assert len(ranks) == n
    for r in ranks:
        assert r["min_gap"] > GAP, f"near tie: top-2 gap {r['min_gap']}"
        got = r["runs"][0]
        assert got["tokens"] == _tokens(ref)
        assert got["account"]["train_waves"] == ref.train_waves
        np.testing.assert_allclose([loss for _, loss in got["wave_losses"]],
                                   [loss for _, loss in ref.wave_losses],
                                   rtol=1e-5, atol=1e-5)


def test_replication_audit(world):
    """No product of the sharded decode step takes a policy-sharded weight
    at its full shape; the one-process step over the same params does."""
    (r0, r1) = world.results("audit")
    for r in (r0, r1):
        assert (64, 96) in [tuple(s) for s in r["forbidden"]]
        assert r["hits"] == [], f"full-shape products: {r['hits']}"
        assert r["ref_hits"], "the audit missed a one-process step's products"


def test_rwkv_with_indivisible_heads_serves_its_time_mix_whole(world):
    """rwkv6 with 3 heads on a 2-way mesh: the time-mix matrices stay
    whole (the one-device path, no state gathered), the channel mix and
    the vocabulary split; tokens and accounting equal the reference's
    single-device engine's."""
    jcfg, pcfg = world.cfgs["odd-rwkv"]
    specs = D.paged_param_specs(pcfg, abstract_params(pcfg), _fake_rules(2))
    layer = specs["segments"]["blocks"]
    assert all(a is None for spec in _leaves(layer["time"]) for a in spec)
    assert layer["chan"]["wk"] == (None, None, ("model",))
    ranks = world.results("odd-rwkv")
    assert len(ranks) == 2
    want = world.ref["odd-rwkv"]
    for r in ranks:
        assert r["min_gap"] > GAP, f"near tie: top-2 gap {r['min_gap']}"
        got = r["runs"][0]
        assert got["tokens"] == _tokens(want)
        assert got["account"] == _account(want)
        assert "state" not in got["bytes"] and got["bytes"]["act"] > 0


def test_spill_tier_restores_across_mesh_widths(world):
    """A tier 2 ranks persisted restores on one process, and the tier that
    one persisted restores on 4 ranks: each restart rehydrates and serves
    the reference's warm second run."""
    ref = world.ref["llama3-8b"]
    first = world.results("persist-0")
    assert first[0]["runs"][0]["tokens"] == _tokens(ref[0])
    for name, n in (("persist-1", 1), ("persist-2", 4)):
        ranks = world.results(name)
        assert len(ranks) == n
        for r in ranks:
            run = r["runs"][0]
            assert run["account"]["rehydrates"] > 0
            assert run["tokens"] == _tokens(ref[1])
            assert run["account"]["prefix_hit_tokens"] == \
                ref[1].prefix_hit_tokens


def test_rank_out_of_step_fails_every_rank(world):
    ranks = world.results("out-of-step")
    assert len(ranks) == 2
    for r in ranks:
        assert "out of step" in r["raised"]


# ---------------------------------------------------------------------------
# specs, rules and rejection paths (no processes)
# ---------------------------------------------------------------------------

def _norm(spec, ndim):
    """A reference PartitionSpec -> the port's per-dim form."""
    out = [None if a is None else ((a,) if isinstance(a, str) else tuple(a))
           for a in tuple(spec)]
    return tuple(out + [None] * (ndim - len(out)))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(arch):
    """`paged_param_specs`, `pool_pspec` and `sharded_param_shapes` equal
    the reference's under its fake rules at every width, for the smoke
    and the published config."""
    for get_j, get_p in ((jget_smoke, get_smoke_config),
                         (jget_config, get_config)):
        jcfg, pcfg = get_j(arch), get_p(arch)
        abs_p = abstract_params(pcfg)
        jabs = jax.eval_shape(lambda: JT.init_params(
            jcfg, jax.random.PRNGKey(0)))
        for n in (1, 2, 3, 4):
            ps = D.paged_param_specs(pcfg, abs_p, _fake_rules(n))
            js = JD.paged_param_specs(jcfg, jabs, _fake_rules(n, JSH))
            flat = jax.tree_util.tree_flatten_with_path(jabs)[0]
            jflat = jax.tree.leaves(js, is_leaf=lambda x: x is None)
            for (path, leaf), jspec in zip(flat, jflat):
                node = ps
                for k in path:
                    node = node[k.key]
                assert node == _norm(jspec, leaf.ndim), (arch, n, path)
            assert D.sharded_param_shapes(pcfg, abs_p, _fake_rules(n)) == \
                JD.sharded_param_shapes(jcfg, jabs, _fake_rules(n, JSH))
            assert D.pool_pspec(_fake_rules(n)) == _norm(
                JD.pool_pspec(_fake_rules(n, JSH)), 4)


def test_cache_shardings_match_reference():
    """`cache_shardings` of a decode cell's contiguous cache: each leaf's
    logical axes resolved as the reference resolves them (its function
    wraps the same specs in NamedShardings of a device mesh)."""
    from repro.configs import SHAPES as JSHAPES
    from repro.launch import specs as JS
    from repro_torch.configs import SHAPES

    def jwalk(node, rules):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = jwalk(v, rules)
                continue
            logical = JS._CACHE_LOGICAL.get(k)
            if logical is None or len(logical) != v.ndim:
                logical = ("layers",) + (None,) * (v.ndim - 1)
            out[k] = _norm(JS.resolve_pspec(v.shape, logical, rules), v.ndim)
        return out

    for arch in ("llama3-8b", "jamba-1.5-large-398b", "rwkv6-3b"):
        jcfg, pcfg = jget_smoke(arch), get_smoke_config(arch)
        for n in (2, 3):
            fake = types.SimpleNamespace(shape={"data": 1, "model": n},
                                         axis_names=("data", "model"))
            got = S.cache_shardings(pcfg, S.cache_abstract(
                pcfg, SHAPES["decode_32k"]), SH.default_rules(fake))
            want = jwalk(JS.cache_abstract(jcfg, JSHAPES["decode_32k"]),
                         JSH.default_rules(fake))
            assert got == want, (arch, n)


def test_pool_sharding_rejects_indivisible_heads():
    """The reference's rejection paths: kv heads (validate and the engine,
    before any device work), query heads, a state-only arch passing
    through, the rules of a mesh with one rank."""
    cfg = get_smoke_config("llama3-8b")        # Hq 4, Hkv 2
    with pytest.raises(ValueError, match="num_kv_heads"):
        D.validate_pool_sharding(cfg, _fake_rules(3))
    params = PT.init_params(cfg, 0, "cpu")
    with pytest.raises(ValueError, match="num_kv_heads"):
        ServeEngine(cfg, params, num_slots=1, max_len=8, page_size=PAGE,
                    rules=_fake_rules(3))
    with pytest.raises(ValueError, match="num_heads"):
        D.validate_pool_sharding(
            dataclasses.replace(cfg, num_heads=6, num_kv_heads=4),
            _fake_rules(4))
    assert D.validate_pool_sharding(cfg, _fake_rules(2)) == 2
    assert D.validate_pool_sharding(get_smoke_config("rwkv6-3b"),
                                    _fake_rules(3)) == 3
    # the recurrent archs build their sharded step (no refusal left)
    for arch in ("rwkv6-3b", "jamba-1.5-large-398b"):
        assert callable(D.make_sharded_paged_step(
            get_smoke_config(arch), _fake_rules(2), page_size=PAGE))


def test_rules_without_a_mesh_are_rejected():
    cfg = get_smoke_config("llama3-8b")
    params = PT.init_params(cfg, 0, "cpu")
    bad = SH.AxisRules({"heads": "model"}, mesh=None, model_axis="model")
    with pytest.raises(ValueError, match="mesh"):
        ServeEngine(cfg, params, num_slots=1, max_len=8, page_size=PAGE,
                    rules=bad)
    with SH.use_rules(bad):
        with pytest.raises(ValueError, match="no mesh"):
            SH.model_axis_size()
    # a world of one process has no 2-rank serve mesh
    with pytest.raises(ValueError, match="2 model shards"):
        make_serve_mesh(2)


@pytest.mark.parametrize("n_shards,block", [(2, 8), (1, 8), (1, 16)],
                         ids=["aligned", "global", "misaligned"])
def test_delta_on_sharded_weights_matches_one_device(n_shards, block,
                                                     monkeypatch):
    """`_delta_local_col`'s three layouts and the row-parallel slice,
    without processes: a fake mesh of 2 ranks (its `group` / `index` are
    all the model code reads), each rank's product on its shard of the
    weight with the whole delta, put back together (the column halves
    side by side; the row-parallel partials summed where the all-reduce
    would sum them) against the one-device product with the delta."""
    from repro_torch.models import common as PC
    rng = np.random.default_rng(0)
    b, s, d_in, n, n_sel = 2, 3, 16, 48, 2
    x = torch.from_numpy(rng.standard_normal((b, s, d_in)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((d_in, n)).astype(np.float32))
    blocks = n // (n_shards * block)
    idx = torch.from_numpy(np.stack([
        np.stack([rng.choice(blocks, n_sel, replace=False)
                  for _ in range(n_shards)]) for _ in range(b)])
        .astype(np.int32))
    val = torch.from_numpy(rng.standard_normal(
        (b, d_in, n_shards, n_sel, block)).astype(np.float32))
    delta = {"idx": {"w": idx}, "val": {"w": val}}
    want = PC.col_matmul(x, w, None, "w", delta, full_out=n)
    # row-parallel: the same delta contracting over w.T's split rows
    xr = torch.from_numpy(rng.standard_normal((b, s, n)).astype(np.float32))
    wr = torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32))
    rdelta = {"idx": {"w": idx}, "val": {"w": torch.from_numpy(
        rng.standard_normal((b, n, n_shards, n_sel, block))
        .astype(np.float32))}}
    want_r = PC.row_matmul(xr, wr, None, "w", rdelta, full_in=n)
    monkeypatch.setattr(SH, "psum_mapped", lambda t, kind="act": t)
    cols, rows = [], []
    for m in range(2):
        fake = types.SimpleNamespace(
            shape={"data": 1, "model": 2}, axis_names=("data", "model"),
            group=lambda axes: object(), index=lambda axes, m=m: m)
        with SH.use_rules(SH.default_rules(fake)), \
                SH.mapped_model_axis("model"):
            cols.append(PC.col_matmul(x, w[:, m * 24:(m + 1) * 24], None,
                                      "w", delta, full_out=n))
            rows.append(PC.row_matmul(xr[..., m * 24:(m + 1) * 24],
                                      wr[m * 24:(m + 1) * 24], None, "w",
                                      rdelta, full_in=n))
    np.testing.assert_allclose(torch.cat(cols, -1).numpy(), want.numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose((rows[0] + rows[1]).numpy(), want_r.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_worker_keeps_to_the_test_threads():
    """Every port test module limits torch's threads at import: this
    worker (or process) runs `TEST_THREADS` of them."""
    assert torch.get_num_threads() == TEST_THREADS == limit_threads()
