"""The port's kernel plain versions against the reference's TPU kernels (run
in interpret mode) and oracles, and the wrappers' CPU dispatch and checks.

The CUDA kernels themselves run only on the card (`python3 chip_smoke.py`
holds them against these same plain versions there)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from repro_torch.testing import limit_threads  # noqa: E402

limit_threads()
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.fused_block_opt import fused_block_opt_kernel  # noqa: E402
from repro.kernels.masked_dw import block_sparse_dw_kernel  # noqa: E402
from repro_torch.core.sparse_update import SelSpec, compact_dw  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402


def _sel_idx(rng, lead_shape, n_blocks, n_sel):
    flat = [rng.choice(n_blocks, n_sel, replace=False)
            for _ in range(int(np.prod(lead_shape)))]
    return np.stack(flat).reshape(lead_shape + (n_sel,)).astype(np.int32)


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(dtype) if dtype is not None else t


# ---------------------------------------------------------------------------
# block_sparse_dw
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("against", ["grid_kernel", "oracle"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_shards", [1, 2])
@pytest.mark.parametrize("m,k,nb,block,n_sel,tm,tk", [
    (64, 32, 4, 16, 3, 32, 16),       # odd n_sel
    (32, 16, 6, 8, 5, 32, 16),        # odd n_sel
])
def test_block_sparse_dw_ref_matches_tpu_kernel(against, dtype, n_shards, m,
                                                k, nb, block, n_sel, tm, tk):
    """The port's plain dW against the TPU grid kernel (interpret mode) and
    the reference's oracle. The reference's pipelined kernel cannot run on
    this JAX (`pltpu.TPUMemorySpace` is gone; its own sweep fails), so
    it is represented by the oracle its sweep holds it against. Tolerance
    1e-5 in both dtypes: bf16 inputs are exact in fp32 and both sides
    accumulate in fp32, so only the summation order differs."""
    rng = np.random.default_rng(m * 7 + nb * n_shards)
    n = n_shards * nb * block
    x = rng.normal(size=(m, k)).astype(np.float32)
    dy = rng.normal(size=(m, n)).astype(np.float32)
    idx = _sel_idx(rng, (n_shards,), nb, n_sel)
    jdt = getattr(jnp, dtype)
    jx, jdy, jidx = jnp.asarray(x, jdt), jnp.asarray(dy, jdt), \
        jnp.asarray(idx)
    if against == "grid_kernel":
        want = block_sparse_dw_kernel(jx, jdy, jidx, block=block, tm=tm,
                                      tk=tk, interpret=True)
    else:
        want = jref.block_sparse_dw_ref(jx, jdy, jidx, block)
    want = np.asarray(want)
    tdt = getattr(torch, dtype)
    got = ref.block_sparse_dw_ref(_t(x, tdt), _t(dy, tdt), _t(idx), block)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (k, n_shards, n_sel, block)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_shards", [1, 2])
def test_compact_dw_full_selection_view_path(n_shards):
    """Full selection takes the reshaped-view einsum + output reorder on the
    CPU; it equals the gathered plain version."""
    rng = np.random.default_rng(3)
    m, k, nb, blk = 24, 12, 4, 8
    spec = SelSpec(block=blk, n_shards=n_shards, n_sel=nb, n_blocks=nb)
    x = _t(rng.normal(size=(m, k)).astype(np.float32))
    dy = _t(rng.normal(size=(m, n_shards * nb * blk)).astype(np.float32))
    idx = _t(_sel_idx(rng, (n_shards,), nb, nb))
    got = compact_dw(x, dy, idx, spec)
    want = ref.block_sparse_dw_ref(x, dy, idx, blk)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# fused_block_opt
# ---------------------------------------------------------------------------

def _opt_inputs(seed, k_steps, n_shards, nb, n_sel, kind, r=48, blk=8):
    rng = np.random.default_rng(seed)
    n = n_shards * nb * blk
    w = rng.normal(size=(k_steps, r, n)).astype(np.float32)
    g = rng.normal(size=(k_steps, r, n_shards, n_sel, blk)).astype(np.float32)
    idx = _sel_idx(rng, (k_steps, n_shards), nb, n_sel)
    mu = nu = None
    if kind in ("momentum", "adamw"):
        mu = rng.normal(size=(k_steps, r, n)).astype(np.float32)
    if kind == "adamw":
        nu = np.abs(rng.normal(size=(k_steps, r, n))).astype(np.float32)
    return w, g, idx, mu, nu


HP = dict(momentum=0.9, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["sgd", "momentum", "adamw"])
@pytest.mark.parametrize("k_steps,n_shards,nb,n_sel", [(1, 1, 4, 1),
                                                       (3, 2, 5, 3)])
def test_fused_block_opt_ref_matches_tpu_kernel(dtype, kind, k_steps,
                                                n_shards, nb, n_sel):
    """The port's plain optimizer pass against the TPU kernel and the
    reference's oracle.

    SGD: bitwise against the reference's eager oracle, which rounds
    `p - lr*g` twice as the port does. Against the interpret-mode kernel,
    which XLA runs with `p - lr*g` and the weight-decay term contracted
    into FMAs, every kind is held to two ulps of the largest weight in the
    stored dtype: an FMA rounds once where PyTorch rounds twice, and pow may
    differ by an ulp between XLA and PyTorch. Momentum / AdamW: 1e-6 in fp32 (pow may differ by an
    ulp between XLA and PyTorch); one ulp of bf16 weights, since such an
    fp32 ulp can flip the bf16 rounding."""
    w, g, idx, mu, nu = _opt_inputs(k_steps * 13 + nb, k_steps, n_shards, nb,
                                    n_sel, kind)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    lr, t = np.float32(0.05), np.float32(3.0)
    hp = dict(kind=kind, **HP)
    jargs = (jnp.asarray(w, jdt), jnp.asarray(g, jdt), jnp.asarray(idx), lr,
             t, None if mu is None else jnp.asarray(mu),
             None if nu is None else jnp.asarray(nu))
    kern = fused_block_opt_kernel(*jargs, tr=16, interpret=True, **hp)
    eager = jref.fused_block_opt_ref(*jargs, **hp)
    got = ref.fused_block_opt_ref(
        _t(w, tdt), _t(g, tdt), _t(idx), torch.tensor(lr), torch.tensor(t),
        None if mu is None else _t(mu), None if nu is None else _t(nu), **hp)
    for a, jk, je in zip(got, kern, eager):
        assert (a is None) == (jk is None)
        if a is None:
            continue
        a32 = a.float().numpy()
        k32 = np.asarray(jk, np.float32)
        if kind == "sgd":
            np.testing.assert_array_equal(a32, np.asarray(je, np.float32))
        tol = 2 * torch.finfo(a.dtype).eps * float(np.abs(k32).max())
        np.testing.assert_allclose(a32, k32, rtol=0, atol=tol)


def test_fused_block_opt_freezes_deselected():
    """Deselected blocks — weights and optimizer state — come back bitwise
    untouched from the wrapper (in place on the CPU via the plain
    version); selected blocks move."""
    w, g, idx, mu, _ = _opt_inputs(0, 2, 2, 4, 1, "momentum", r=32)
    tw, tmu = _t(w.copy()), _t(mu.copy())
    hyper = torch.tensor([0.1, 1.0])
    out = ops.fused_block_opt(tw, _t(g), _t(idx), hyper, tmu,
                              kind="momentum", momentum=0.9)
    assert out[0] is tw and out[1] is tmu
    sel = np.zeros((2, 32, 2, 4, 8), bool)
    for kk in range(2):
        for s in range(2):
            sel[kk, :, s, idx[kk, s], :] = True
    sel = sel.reshape(w.shape)
    for before, after in ((w, tw.numpy()), (mu, tmu.numpy())):
        np.testing.assert_array_equal(after[~sel], before[~sel])
        assert np.abs(after[sel] - before[sel]).max() > 0


# ---------------------------------------------------------------------------
# wrappers: CPU dispatch, launch counts, argument checks
# ---------------------------------------------------------------------------

def test_wrappers_take_the_plain_path_on_cpu_and_count_nothing():
    rng = np.random.default_rng(1)
    ops.reset_launch_counts()
    spec = SelSpec(block=8, n_shards=2, n_sel=2, n_blocks=3)
    x = _t(rng.normal(size=(16, 8)).astype(np.float32))
    dy = _t(rng.normal(size=(16, 48)).astype(np.float32))
    idx = _t(_sel_idx(rng, (2,), 3, 2))
    for pipelined in (None, True, False):
        got = ops.block_sparse_dw(x, dy, idx, spec, pipelined=pipelined)
        torch.testing.assert_close(got, ref.block_sparse_dw_ref(x, dy, idx, 8))
    w, g, oidx, mu, nu = _opt_inputs(2, 2, 1, 4, 2, "adamw")
    ops.fused_block_opt(_t(w), _t(g), _t(oidx), torch.tensor([0.1, 1.0]),
                        _t(mu), _t(nu), kind="adamw")
    y = ops.block_act_prune_fwd(x, 0.15, 2)
    ops.block_act_prune_bwd(x, y, 0.15, 2)
    for pipelined in (None, True, False):
        got = ops.block_sparse_dw_batched(x.reshape(2, 8, 8),
                                          dy.reshape(2, 8, 48), idx, spec,
                                          pipelined=pipelined)
        torch.testing.assert_close(got, ref.batched_dw_ref(
            x.reshape(2, 8, 8), dy.reshape(2, 8, 48), idx, 8))
    w3 = _t(w)
    got = ops.block_scatter_update(w3, _t(g), _t(oidx),
                                   SelSpec(block=8, n_shards=1, n_sel=2,
                                           n_blocks=4))
    assert got is w3
    r, kk, v = (_t(rng.normal(size=(1, 8, 2, 16)).astype(np.float32))
                for _ in range(3))
    wd = _t(rng.uniform(0.1, 0.9, size=(1, 8, 2, 16)).astype(np.float32))
    u = _t(rng.normal(size=(2, 16)).astype(np.float32))
    y = ops.wkv6_fwd(r, kk, v, wd, u)
    torch.testing.assert_close(y, ref.wkv6_ref(r, kk, v, wd, u))
    ops.wkv6_bwd(r, kk, v, wd, u, y)
    assert ops.launch_counts() == {"block_sparse_dw": 0, "batched_dw": 0,
                                   "fused_block_opt": 0,
                                   "block_act_prune": 0,
                                   "block_act_prune_bwd": 0,
                                   "block_scatter_update": 0,
                                   "wkv6": 0, "wkv6_bwd": 0}


def _dw_args():
    rng = np.random.default_rng(2)
    spec = SelSpec(block=8, n_shards=1, n_sel=2, n_blocks=4)
    x = _t(rng.normal(size=(16, 8)).astype(np.float32))
    dy = _t(rng.normal(size=(16, 32)).astype(np.float32))
    idx = _t(_sel_idx(rng, (1,), 4, 2))
    return x, dy, idx, spec


@pytest.mark.parametrize("bad", ["dtype", "mixed_dtype", "idx_dtype", "shape",
                                 "m_mismatch", "contiguity"])
def test_block_sparse_dw_wrapper_raises(bad):
    x, dy, idx, spec = _dw_args()
    if bad == "dtype":
        x, dy = x.half(), dy.half()
    elif bad == "mixed_dtype":
        dy = dy.bfloat16()
    elif bad == "idx_dtype":
        idx = idx.long()
    elif bad == "shape":
        dy = dy[:, :30].contiguous()
    elif bad == "m_mismatch":
        dy = dy[:8].contiguous()
    elif bad == "contiguity":
        x = torch.cat([x, x], 1)[:, ::2]
    with pytest.raises(ValueError):
        ops.block_sparse_dw(x, dy, idx, spec)


@pytest.mark.parametrize("bad", ["dtype", "shape", "state", "contiguity",
                                 "hyper"])
def test_fused_block_opt_wrapper_raises(bad):
    w, g, idx, mu, _ = _opt_inputs(4, 2, 1, 4, 2, "momentum")
    tw, tg, tidx, tmu = _t(w), _t(g), _t(idx), _t(mu)
    hyper = torch.tensor([0.1, 1.0])
    kw = dict(kind="momentum", momentum=0.9)
    if bad == "dtype":
        tw = tw.half()
    elif bad == "shape":
        tg = tg[:, :, :, :1].contiguous()
    elif bad == "state":
        tmu = None
    elif bad == "contiguity":
        tw = torch.cat([tw, tw], 2)[:, :, ::2]
    elif bad == "hyper":
        hyper = hyper.double()
    with pytest.raises(ValueError):
        ops.fused_block_opt(tw, tg, tidx, hyper, tmu, **kw)


def test_fused_block_optimizer_flattens_lead_dims():
    """A leaf with extra lead dims ([K, E, d, N]) is one call over rows."""
    rng = np.random.default_rng(5)
    k, e, d, s, nb, blk, n_sel = 2, 3, 4, 1, 4, 8, 2
    spec = SelSpec(block=blk, n_shards=s, n_sel=n_sel, n_blocks=nb)
    p = _t(rng.normal(size=(k, e, d, s * nb * blk)).astype(np.float32))
    g = _t(rng.normal(size=(k, e, d, s, n_sel, blk)).astype(np.float32))
    idx = _t(_sel_idx(rng, (k, s), nb, n_sel))
    p0 = p.clone()
    from repro_torch.configs import OptimizerConfig
    oc = OptimizerConfig(kind="sgd", learning_rate=0.1)
    ops.fused_block_optimizer(oc, p, g, idx, spec, None, None,
                              torch.tensor([0.1, 1.0]))
    want = ref.fused_block_opt_ref(p0.reshape(k, e * d, -1),
                                   g.reshape(k, e * d, s, n_sel, blk), idx,
                                   torch.tensor(0.1), torch.tensor(1.0),
                                   kind="sgd")[0]
    assert torch.equal(p.reshape(k, e * d, -1), want)


def test_build_is_lazy_and_keyed_by_source():
    """Importing the build module compiles nothing; the library path is a
    function of the source and its flags."""
    from repro_torch.kernels import build
    assert build._LIBS == {}
    a, b = build.lib_path("block_sparse_dw"), build.lib_path("fused_block_opt")
    assert a != b and a.parent == build.BUILD_DIR
    assert "-fmad=false" in build._flags("fused_block_opt")
    assert "--use_fast_math" not in " ".join(
        build._flags("block_sparse_dw") + build._flags("fused_block_opt"))
    assert "arch=compute_90a,code=sm_90a" in build._flags("block_sparse_dw")
