"""The port's MoE pieces against the reference on the deepseek-moe-16b smoke
config: the expert-batched dW's plain version against the reference's TPU
grid kernel (interpret mode) and oracle, the batched sparse-matmul
autograd Functions against the reference's custom VJPs, and the MoE layer
(routing, capacity, dispatch and combine, aux losses, gradients). Inputs
come from numpy seeds; parameters from the reference's init, bridged."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from repro_torch.testing import limit_threads  # noqa: E402

limit_threads()
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.core import sparse_update as JSU  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.batched_dw import batched_dw_kernel  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import sparse_update as PSU  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import moe as PMOE  # noqa: E402

NEAR_TIE = 1e-5


def _sel_idx(rng, n_shards, n_blocks, n_sel):
    return np.stack([rng.choice(n_blocks, n_sel, replace=False)
                     for _ in range(n_shards)]).astype(np.int32)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a, copy=True))
    return t.to(dtype) if dtype is not None else t


# ---------------------------------------------------------------------------
# batched dW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("against", ["grid_kernel", "oracle"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e,c,k,n_shards,nb,block,n_sel,tk", [
    (3, 21, 32, 1, 5, 8, 3, 16),     # ragged C, odd n_sel
    (2, 37, 16, 2, 4, 16, 1, 16),    # ragged C, several shards
    (4, 32, 24, 3, 3, 8, 2, 8),      # three shards
])
def test_batched_dw_ref_matches_tpu_kernel(against, dtype, e, c, k, n_shards,
                                           nb, block, n_sel, tk):
    """The port's plain batched dW against the reference's TPU grid kernel
    (interpret mode, a C tile of the whole capacity) and its oracle. The
    reference's pipelined kernel fails on this JAX (`pltpu.TPUMemorySpace`
    is gone; its own sweep fails), so the oracle stands for it. 1e-5 in both
    dtypes: bf16 inputs are exact in fp32, only the summation order
    differs."""
    rng = np.random.default_rng(e * 100 + c)
    n = n_shards * nb * block
    x = rng.normal(size=(e, c, k)).astype(np.float32)
    dy = rng.normal(size=(e, c, n)).astype(np.float32)
    idx = _sel_idx(rng, n_shards, nb, n_sel)
    jdt = getattr(jnp, dtype)
    jx, jdy, jidx = jnp.asarray(x, jdt), jnp.asarray(dy, jdt), \
        jnp.asarray(idx)
    if against == "grid_kernel":
        want = batched_dw_kernel(jx, jdy, jidx, block=block, tm=c, tk=tk,
                                 interpret=True)
    else:
        want = jref.batched_dw_ref(jx, jdy, jidx, block)
    tdt = getattr(torch, dtype)
    got = ref.batched_dw_ref(_t(x, tdt), _t(dy, tdt), _t(idx), block)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (e, k, n_shards, n_sel, block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_batched_dw_wrapper_dispatch_and_checks():
    """On CPU tensors the wrapper runs the plain version and counts no
    launch; it refuses what the kernel does not take."""
    rng = np.random.default_rng(0)
    spec = PSU.SelSpec(block=8, n_shards=1, n_sel=2, n_blocks=4)
    x = _t(rng.normal(size=(2, 5, 16)).astype(np.float32))
    dy = _t(rng.normal(size=(2, 5, 32)).astype(np.float32))
    idx = _t(_sel_idx(rng, 1, 4, 2))
    ops.reset_launch_counts()
    got = ops.block_sparse_dw_batched(x, dy, idx, spec)
    assert torch.equal(got, ref.batched_dw_ref(x, dy, idx, 8))
    assert ops.launch_counts()["batched_dw"] == 0
    bad = [(x[0], dy, idx), (x, dy[:, :4], idx), (x, dy.to(torch.bfloat16),
                                                  idx),
           (x, dy, idx.long()), (x.transpose(1, 2).contiguous()
                                 .transpose(1, 2), dy, idx),
           (x, dy[..., :30], idx)]
    for args in bad:
        with pytest.raises(ValueError):
            ops.block_sparse_dw_batched(*args, spec)


# ---------------------------------------------------------------------------
# batched sparse matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards,n_sel", [(1, 2), (2, 1), (1, 3)])
def test_batched_smm_functions_match_reference_vjps(n_shards, n_sel):
    """Forward, dx, the compact dW (to w_sel), the zero cotangent of w on
    the compact form, and the dense-scatter dW with every unselected block
    exactly 0, against `_smm_batched` / `_smm_batched_compact` under
    jax.vjp (f32, 1e-5)."""
    rng = np.random.default_rng(n_shards * 10 + n_sel)
    e, c, k, nb, block = 3, 7, 12, 3, 4
    n = n_shards * nb * block
    jspec = JSU.SelSpec(block=block, n_shards=n_shards, n_sel=n_sel,
                        n_blocks=nb)
    pspec = PSU.SelSpec(*jspec)
    x = rng.normal(size=(e, c, k)).astype(np.float32)
    w = rng.normal(size=(e, k, n)).astype(np.float32)
    cot = rng.normal(size=(e, c, n)).astype(np.float32)
    idx = _sel_idx(rng, n_shards, nb, n_sel)
    w_sel = np.take_along_axis(w.reshape(e, k, n_shards, nb, block),
                               idx[None, None, :, :, None], axis=3)

    y, vjp = jax.vjp(lambda a, b: JSU._smm_batched(a, b, jnp.asarray(idx),
                                                   jspec), x, w)
    jdx, jdw = vjp(jnp.asarray(cot))
    yc, vjpc = jax.vjp(lambda a, b, s: JSU._smm_batched_compact(
        a, b, s, jnp.asarray(idx), jspec), x, w, w_sel)
    cdx, cdw, cdsel = vjpc(jnp.asarray(cot))
    assert not np.any(np.asarray(cdw))          # w's cotangent is zero

    tx, tw = _t(x).requires_grad_(True), _t(w).requires_grad_(True)
    out = PSU.smm(tx, tw, ({"w": _t(idx)}, {"w": pspec}), "w")
    out.backward(_t(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), rtol=1e-5,
                               atol=1e-5)
    # the dense-scatter dW is exactly zero outside the selected blocks
    dwb = tw.grad.reshape(e, k, n_shards, nb, block)
    mask = torch.zeros(n_shards, nb, dtype=torch.bool)
    mask[torch.arange(n_shards)[:, None], _t(idx).long()] = True
    assert torch.all(dwb[:, :, ~mask] == 0)

    tx2, tw2 = _t(x).requires_grad_(True), _t(w).requires_grad_(True)
    tsel = _t(w_sel).requires_grad_(True)
    out = PSU.smm(tx2, tw2, ({"w": _t(idx)}, {"w": pspec}, {"w": tsel}), "w")
    out.backward(_t(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(yc),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tx2.grad.numpy(), np.asarray(cdx), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tsel.grad.numpy(), np.asarray(cdsel),
                               rtol=1e-5, atol=1e-5)
    assert tw2.grad is None                    # w entered detached


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------

def _moe_setup(dtype="float32", seed=0, b=2, s=16, capacity_factor=None,
               scale=1.0):
    jcfg = dataclasses.replace(jget_smoke("deepseek-moe-16b"), dtype=dtype)
    pcfg = dataclasses.replace(get_smoke_config("deepseek-moe-16b"),
                               dtype=dtype)
    if capacity_factor is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=capacity_factor))
        pcfg = dataclasses.replace(pcfg, moe=dataclasses.replace(
            pcfg.moe, capacity_factor=capacity_factor))
    params = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    jp = jax.tree.map(lambda a: a[0], params["segments"]["blocks"])["moe"]
    jp = jax.device_get(jp)
    rng = np.random.default_rng(seed + 1)
    x = (rng.normal(size=(b, s, jcfg.d_model)) * scale).astype(np.float32)
    return jcfg, pcfg, jp, x


def _probe_near_ties(probs, k: int, where: str):
    """Fail, naming the token, where the k-th and (k+1)-th probabilities of
    a token lie within NEAR_TIE: there one ulp of the fp32 router logits
    can swap an expert between the frameworks."""
    p = np.sort(np.asarray(probs, np.float32), axis=-1)[:, ::-1]
    gap = p[:, k - 1] - p[:, k]
    bad = np.nonzero(gap < NEAR_TIE)[0]
    assert bad.size == 0, (
        f"{where}: tokens {bad.tolist()} have a top-k near-tie (gap "
        f"{gap[bad].tolist()} < {NEAR_TIE}); pick another seed rather "
        f"than loosen the comparison")


def _jrouting(jp, jcfg, x):
    x_flat = jnp.asarray(x).reshape(-1, jcfg.d_model)
    logits = x_flat.astype(jnp.float32) @ jp["router"]
    probs = jax.nn.softmax(logits, axis=-1)
    weights, ids = jax.lax.top_k(probs, jcfg.moe.top_k)
    weights = weights / jnp.maximum(weights.sum(-1, keepdims=True), 1e-9)
    return np.asarray(probs), np.asarray(weights), np.asarray(ids)


def _kept_like_reference(ids, e: int, capacity: int):
    """The reference's drop rule in numpy: a stable sort of the flat
    (token-major) choices by expert; the first `capacity` of each stay."""
    flat = ids.reshape(-1)
    order = np.argsort(flat, kind="stable")
    counts = np.bincount(flat, minlength=e)
    starts = np.cumsum(counts) - counts
    pos = np.empty_like(flat)
    pos[order] = np.arange(flat.size) - starts[flat[order]]
    return (pos < capacity).reshape(ids.shape)


@pytest.mark.parametrize("capacity_factor", [None, 0.5],
                         ids=["cf1.25", "cf0.5_drops"])
@pytest.mark.parametrize("seed", [0, 1])
def test_routing_and_capacity_match_reference(seed, capacity_factor):
    """ids, weights, capacity and the kept choices against the reference's
    routing (f32): ids equal, weights within 1e-6; at capacity factor 0.5
    the capacity drops choices, and the same ones."""
    jcfg, pcfg, jp, x = _moe_setup(seed=seed,
                                   capacity_factor=capacity_factor, s=32)
    jprobs, jw, jids = _jrouting(jp, jcfg, x)
    _probe_near_ties(jprobs, jcfg.moe.top_k, f"seed {seed}")
    k, e = pcfg.moe.top_k, pcfg.moe.num_experts
    _, probs, w, ids = PMOE.route(_t(jp["router"]),
                                  _t(x).reshape(-1, pcfg.d_model), k)
    np.testing.assert_allclose(probs.numpy(), jprobs, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(ids.numpy(), jids)
    np.testing.assert_allclose(w.numpy(), jw, rtol=1e-6, atol=1e-7)
    t = x.shape[0] * x.shape[1]
    cap = PMOE._capacity(t, k, pcfg.moe.capacity_factor, e)
    assert cap == JMOE._capacity(t, k, jcfg.moe.capacity_factor, e)
    _, kept = PMOE.dispatch_slots(torch.sort(ids, dim=1)[0], e, cap)
    want = _kept_like_reference(np.sort(jids, axis=1), e, cap)
    np.testing.assert_array_equal(kept.numpy(), want)
    if capacity_factor == 0.5:
        assert not want.all()                   # the case drops choices


@pytest.mark.parametrize("capacity_factor", [None, 0.5],
                         ids=["cf1.25", "cf0.5_drops"])
def test_apply_moe_matches_reference(capacity_factor):
    """apply_moe's output and both aux losses against the reference (f32,
    1e-5 of the largest output; aux 1e-6 relative), and the reference's
    own check that the load balance is >= 1 (Cauchy-Schwarz)."""
    jcfg, pcfg, jp, x = _moe_setup(capacity_factor=capacity_factor)
    jprobs, _, _ = _jrouting(jp, jcfg, x)
    _probe_near_ties(jprobs, jcfg.moe.top_k, "apply_moe")
    jy, jaux = JMOE.apply_moe(jp, jcfg, jnp.asarray(x))
    y, aux = PMOE.apply_moe(bridge.to_torch(jp), pcfg, _t(x))
    jy = np.asarray(jy)
    assert tuple(y.shape) == x.shape and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), jy, rtol=1e-5,
                               atol=1e-5 * float(np.abs(jy).max()))
    for key in ("load_balance", "router_z"):
        assert float(aux[key]) == pytest.approx(float(jaux[key]), rel=1e-6)
    assert float(aux["load_balance"]) >= 1.0 - 1e-3
    assert bool(torch.isfinite(y).all())


def test_apply_moe_gradients_match_reference():
    """Gradients of sum(y * cot) + the weighted aux losses with respect to
    x, the router, the routed experts and the shared MLP, against
    jax.grad (f32, 1e-5 of each gradient's largest entry): the backward
    through the dispatch, the combine, top-k and the aux losses."""
    jcfg, pcfg, jp, x = _moe_setup(capacity_factor=0.5)
    jprobs, _, _ = _jrouting(jp, jcfg, x)
    _probe_near_ties(jprobs, jcfg.moe.top_k, "gradients")
    cot = np.random.default_rng(7).normal(size=x.shape).astype(np.float32)

    def jloss(p, xx):
        y, aux = JMOE.apply_moe(p, jcfg, xx)
        return (jnp.vdot(y, jnp.asarray(cot)) + 0.01 * aux["load_balance"]
                + 1e-3 * aux["router_z"])

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = PSU.tree_map(lambda a: a.requires_grad_(True),
                          bridge.to_torch(jp))
    tx = _t(x).requires_grad_(True)
    y, aux = PMOE.apply_moe(leaves, pcfg, tx)
    loss = ((y * _t(cot)).sum() + 0.01 * aux["load_balance"]
            + 1e-3 * aux["router_z"])
    loss.backward()
    got = PSU.tree_map(lambda a: a.grad.numpy(), leaves)
    for (path, want), g in zip(jax.tree_util.tree_leaves_with_path(jgp),
                               jax.tree.leaves(got)):
        want = np.asarray(want)
        np.testing.assert_allclose(g, want, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()),
                                   err_msg=str(path))
    jgx = np.asarray(jgx)
    np.testing.assert_allclose(tx.grad.numpy(), jgx, rtol=1e-5,
                               atol=1e-5 * float(np.abs(jgx).max()))


def test_apply_moe_bf16_matches_reference_loosely():
    """One bf16 run: the experts' inputs, products and the combine round to
    bf16 at other places in the two frameworks; the router stays fp32, so
    the routing is the same. Output within 2e-2 of its largest value, aux
    losses within 1e-3 relative (they read the fp32 router only)."""
    jcfg, pcfg, jp, x = _moe_setup(dtype="bfloat16")
    assert jp["router"].dtype == np.float32
    assert jp["w_gate"].dtype == jnp.bfloat16
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16))
    jprobs, _, _ = _jrouting(jp, jcfg, np.asarray(xb, np.float32))
    _probe_near_ties(jprobs, jcfg.moe.top_k, "bf16")
    jy, jaux = JMOE.apply_moe(jp, jcfg, jnp.asarray(xb))
    y, aux = PMOE.apply_moe(bridge.to_torch(jp), pcfg, bridge.to_torch(xb))
    assert y.dtype == torch.bfloat16
    jy = np.asarray(jy, np.float32)
    np.testing.assert_allclose(y.float().numpy(), jy, rtol=2e-2,
                               atol=2e-2 * float(np.abs(jy).max()))
    for key in ("load_balance", "router_z"):
        assert float(aux[key]) == pytest.approx(float(jaux[key]), rel=1e-3)


def test_moe_init_keeps_the_router_fp32():
    """A bf16 model's router stays fp32, as the reference's; the expert
    leaves take the model's type and the reference's shapes."""
    cfg = dataclasses.replace(get_smoke_config("deepseek-moe-16b"),
                              dtype="bfloat16")
    p = PMOE.init_moe(torch.Generator().manual_seed(0), cfg, torch.bfloat16,
                      device="cpu")
    jcfg = dataclasses.replace(jget_smoke("deepseek-moe-16b"),
                               dtype="bfloat16")
    want = jax.eval_shape(lambda: JMOE.init_moe(jax.random.PRNGKey(0), jcfg,
                                                jnp.bfloat16))
    assert p["router"].dtype == torch.float32
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        node = p
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape, path
        assert str(node.dtype).split(".")[-1] == str(leaf.dtype), path


def test_apply_moe_refuses_sharded_expert_weights():
    """Experts whose hidden dim arrived split are refused off a mesh (their
    all-reduce would be skipped). On a 2-rank serve mesh they take the
    d_ff-parallel form (`launch.mesh_serve`'s "moe" job: every expert
    resident, each rank half of d_ff, one all-reduce after the combine),
    which equals the whole-expert form within f32 roundoff (1e-5 of the
    largest output: the w_down sums split in two)."""
    from repro_torch.launch import mesh, mesh_serve
    _, pcfg, jp, x = _moe_setup()
    p = bridge.to_torch(jp)
    p["w_gate"] = p["w_gate"][..., :16]
    with pytest.raises(ValueError, match="no process mesh"):
        PMOE.apply_moe(p, pcfg, _t(x))
    job = dict(name="moe", kind="moe", cfg=pcfg, n=2, params=jp, x=x)
    ranks = mesh.spawn(mesh_serve.run_jobs, 2, args=([job],), timeout_s=120)
    want, _ = PMOE.apply_moe(bridge.to_torch(jp), pcfg, _t(x))
    want = want.numpy()
    for (r,) in ranks:
        assert r["d_ff_local"] * 2 == pcfg.d_ff
        np.testing.assert_allclose(r["y"].numpy(), want, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()))
