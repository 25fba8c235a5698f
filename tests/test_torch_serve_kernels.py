"""The block scatter-update's plain version and wrapper against the
reference's TPU kernel (interpret mode) and oracle, and `scatter_param_blocks`
against the reference's, on the same numpy inputs.

The scatter is pure write routing plus a cast to the weight's type: every
comparison here is exact. The CUDA kernel itself runs only on the card
(`python3 chip_smoke.py` holds it bitwise against the same plain version
there)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import sparse_update as J  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.scatter_blocks import block_scatter_update_kernel  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import sparse_update as P  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402


def _sel_idx(rng, lead_shape, n_blocks, n_sel):
    flat = [rng.choice(n_blocks, n_sel, replace=False)
            for _ in range(int(np.prod(lead_shape)))]
    return np.stack(flat).reshape(lead_shape + (n_sel,)).astype(np.int32)


def _np(a):
    return np.asarray(a, np.float32)


def _inputs(rng, k, r, s, nb, blk, n_sel, dtype):
    n = s * nb * blk
    w = jnp.asarray(rng.normal(size=(k, r, n)), dtype)
    upd = jnp.asarray(rng.normal(size=(k, r, s, n_sel, blk)), jnp.float32)
    idx = _sel_idx(rng, (k, s), nb, n_sel)
    return w, upd, idx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k_steps", [1, 3])
@pytest.mark.parametrize("n_shards", [1, 2])
@pytest.mark.parametrize("r,nb,blk,n_sel,tr", [
    (32, 8, 8, 3, 32),        # odd n_sel
    (64, 4, 16, 2, 32),
    (16, 2, 128, 1, 16),      # the training path's channel block
    (48, 6, 8, 6, 16),        # full selection: every block overwritten
])
def test_block_scatter_update_ref_matches_tpu_kernel(dtype, k_steps,
                                                     n_shards, r, nb, blk,
                                                     n_sel, tr):
    """Plain version == interpret-mode TPU kernel == reference oracle,
    exactly; the upd arrives fp32 and is cast to w's type on the store (the
    reference's `scatter_param_blocks` casts before its kernel)."""
    rng = np.random.default_rng(r * 3 + nb + k_steps * n_shards)
    w, upd, idx = _inputs(rng, k_steps, r, n_shards, nb, blk, n_sel, dtype)
    want = block_scatter_update_kernel(w, upd.astype(w.dtype), idx, tr=tr,
                                       interpret=True)
    oracle = jref.block_scatter_update_ref(w, upd, idx, blk)
    tw, tu, ti = (bridge.to_torch(np.asarray(a)) for a in (w, upd, idx))
    got = ref.block_scatter_update_ref(tw, tu, ti, blk)
    assert got.dtype == tw.dtype
    np.testing.assert_array_equal(_np(bridge.to_numpy(got)), _np(want))
    np.testing.assert_array_equal(_np(bridge.to_numpy(got)), _np(oracle))
    # the wrapper: in place on its argument, the same values
    spec = P.SelSpec(block=blk, n_shards=n_shards, n_sel=n_sel, n_blocks=nb)
    out = ops.block_scatter_update(tw, tu, ti, spec)
    assert out is tw
    np.testing.assert_array_equal(_np(bridge.to_numpy(tw)), _np(want))


@pytest.mark.parametrize("seed", range(6))
def test_block_scatter_update_keeps_unselected_blocks(seed):
    """Every unselected block keeps its bits (the sign of zero included);
    every selected block holds upd cast to w's type. (No NaN among the
    values: PyTorch's CPU scatter rewrites the payload of a bf16 NaN in a
    row it scatters into, so the plain version keeps NaNs, not their bits;
    the kernel never touches an unselected block at all.)"""
    rng = np.random.default_rng(seed)
    k, s, nb, blk = 2, int(rng.integers(1, 3)), int(rng.integers(2, 7)), 8
    r, n_sel = 16 * int(rng.integers(1, 4)), int(rng.integers(1, nb + 1))
    w = torch.from_numpy(rng.normal(size=(k, r, s * nb * blk)).astype(
        np.float32)).to(torch.bfloat16)
    w.view(-1)[:5] = torch.tensor([-0.0, float("-inf"), float("inf"), 0.0,
                                   -1.0], dtype=torch.bfloat16)
    upd = torch.from_numpy(rng.normal(size=(k, r, s, n_sel, blk)).astype(
        np.float32))
    idx = torch.from_numpy(_sel_idx(rng, (k, s), nb, n_sel))
    before = w.clone()
    spec = P.SelSpec(block=blk, n_shards=s, n_sel=n_sel, n_blocks=nb)
    ops.block_scatter_update(w, upd, idx, spec)
    sel = ref.scatter_blocks3(torch.zeros(w.shape, dtype=torch.int16),
                              torch.ones(upd.shape, dtype=torch.int16), idx,
                              blk).bool()
    bits, old = w.view(torch.int16), before.view(torch.int16)
    assert torch.equal(bits[~sel], old[~sel])
    assert torch.equal(P.gather_param_blocks(w, idx, spec),
                       upd.to(torch.bfloat16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lead", [(), (3,), (2, 3)])
def test_scatter_param_blocks_with_lead_dims_matches_reference(dtype, lead):
    """A stacked leaf [K, *lead, d, N] (an expert axis) through the port's
    `scatter_param_blocks` == the reference's, on its jnp path and through
    its kernel (interpret mode); the port never writes its input."""
    rng = np.random.default_rng(len(lead) + (dtype == "bfloat16"))
    k, d, s, nb, blk, n_sel = 2, 5, 2, 4, 8, 3
    w = jnp.asarray(rng.normal(size=(k,) + lead + (d, s * nb * blk)), dtype)
    vals = jnp.asarray(rng.normal(size=(k,) + lead + (d, s, n_sel, blk)),
                       jnp.float32)
    idx = jnp.asarray(_sel_idx(rng, (k, s), nb, n_sel))
    jspec = J.SelSpec(block=blk, n_shards=s, n_sel=n_sel, n_blocks=nb)
    want = J.scatter_param_blocks(w, vals, idx, jspec)
    with J.use_kernels(True):
        want_kernel = J.scatter_param_blocks(w, vals, idx, jspec)
    tw = bridge.to_torch(np.asarray(w))
    before = tw.clone()
    got = P.scatter_param_blocks(tw, bridge.to_torch(np.asarray(vals)),
                                 bridge.to_torch(np.asarray(idx)),
                                 P.SelSpec(*jspec))
    assert got.shape == tw.shape and got.dtype == tw.dtype
    assert torch.equal(tw, before), "scatter_param_blocks wrote its input"
    np.testing.assert_array_equal(_np(bridge.to_numpy(got)), _np(want))
    np.testing.assert_array_equal(_np(bridge.to_numpy(got)),
                                  _np(want_kernel))


def _scatter_args():
    rng = np.random.default_rng(3)
    spec = P.SelSpec(block=8, n_shards=1, n_sel=2, n_blocks=4)
    w = torch.from_numpy(rng.normal(size=(2, 4, 32)).astype(np.float32))
    vals = torch.from_numpy(rng.normal(size=(2, 4, 1, 2, 8)).astype(
        np.float32))
    idx = torch.from_numpy(_sel_idx(rng, (2, 1), 4, 2))
    return w, vals, idx, spec


@pytest.mark.parametrize("bad", ["w_dtype", "vals_dtype", "idx_dtype",
                                 "shape", "contiguity"])
def test_block_scatter_update_wrapper_raises(bad):
    w, vals, idx, spec = _scatter_args()
    if bad == "w_dtype":
        w = w.to(torch.int8)
    elif bad == "vals_dtype":
        w, vals = w.to(torch.bfloat16), vals.to(torch.float16)
    elif bad == "idx_dtype":
        idx = idx.long()
    elif bad == "shape":
        vals = vals[:, :, :, :1].contiguous()
    else:
        w = w.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError):
        ops.block_scatter_update(w, vals, idx, spec)
