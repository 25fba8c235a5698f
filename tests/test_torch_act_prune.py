"""The port's block activation pruning against the reference: the plain
versions (what the wrappers run on CPU tensors, and what the CUDA kernel is
held against on the card by `python3 chip_smoke.py`) against the TPU kernel
in interpret mode and the reference's jnp version, forward and backward.

Every comparison is bitwise (the sign of zero included): the op multiplies
by 0 or 1, which is exact in both frameworks."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from repro_torch.testing import limit_threads  # noqa: E402

limit_threads()
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import act_prune as jap  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.block_act_prune import block_act_prune_kernel  # noqa: E402
from repro_torch.core import act_prune as pap  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402


def _bits(a) -> np.ndarray:
    """fp32 bit patterns (bf16 widens to fp32 exactly)."""
    return np.asarray(a, np.float32).view(np.uint32)


def _pair(x: np.ndarray, dtype: str):
    return jnp.asarray(x, getattr(jnp, dtype)), \
        torch.from_numpy(x).to(getattr(torch, dtype))


def _tbits(t) -> np.ndarray:
    return _bits(t.float().numpy())


# the reference's own sweep (tests/test_kernels.py::test_block_act_prune_sweep)
SWEEP = [(64, 64, 32, 32, 2, 0.15), (128, 256, 64, 128, 2, 0.15),
         (32, 128, 32, 64, 4, 0.3), (256, 512, 256, 512, 2, 0.05)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("r,c,tr,tc,blk,thr", SWEEP)
def test_forward_matches_tpu_kernel_and_jnp(dtype, r, c, tr, tc, blk, thr):
    """Plain version, and the wrapper's CPU dispatch, against the TPU kernel
    (interpret mode) and the jnp version, bitwise. Signed normal inputs, so
    pruned negatives give -0.0 on both sides; bf16 compares against the
    threshold rounded to bf16 on both sides."""
    x = (np.random.default_rng(r + c).normal(size=(r, c)) * 0.3) \
        .astype(np.float32)
    jx, tx = _pair(x, dtype)
    kern = block_act_prune_kernel(jx, threshold=thr, block=blk, tr=tr, tc=tc,
                                  interpret=True)
    jnp_v = jap.block_act_prune(jx, thr, blk)
    got = ref.block_act_prune_ref(tx, thr, blk)
    via_op = ops.block_act_prune(tx, thr, blk)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    for want in (kern, jnp_v, jref.block_act_prune_ref(jx, thr, blk)):
        np.testing.assert_array_equal(_tbits(got), _bits(want))
    np.testing.assert_array_equal(_tbits(via_op), _tbits(got))
    assert (_tbits(got) == 0x80000000).any()   # -0.0 present and matched


def test_forward_nd_input():
    """An N-d activation [B, H, W, C] (the CNN's NHWC) through the op, as
    the reference's `ops.block_act_prune` takes it (its
    test_ops_block_act_prune_nd): bitwise."""
    x = (np.random.default_rng(1).normal(size=(2, 3, 8, 64)) * 0.2) \
        .astype(np.float32)
    jx, tx = _pair(x, "float32")
    want = jref.block_act_prune_ref(jx, 0.15, 2)
    got = pap.make_act_pruner(0.15, 2)(tx)
    np.testing.assert_array_equal(_tbits(got), _bits(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("thr", [0.15, 0.3, 0.0, -1.0])
@pytest.mark.parametrize("blk", [2, 4])
def test_backward_matches_jax_grad(dtype, thr, blk):
    """The autograd Function's backward (the mask taken from the saved
    output) against jax.vjp of the jnp version, bitwise, threshold 0 and
    below included (every block kept: dx == dy)."""
    rng = np.random.default_rng(blk * 1000 + int(thr * 100) + 100)
    x = (rng.normal(size=(4, 6, 6, 16)) * 0.3).astype(np.float32)
    dy = rng.normal(size=x.shape).astype(np.float32)
    jx, tx = _pair(x, dtype)
    jdy, tdy = _pair(dy, dtype)
    _, vjp = jax.vjp(lambda v: jap.block_act_prune(v, thr, blk), jx)
    (want,) = vjp(jdy)
    tx.requires_grad_(True)
    y = pap.block_act_prune(tx, threshold=thr, block=blk)
    (got,) = torch.autograd.grad(y, tx, tdy)
    np.testing.assert_array_equal(_tbits(got), _bits(want))
    bwd = ref.block_act_prune_bwd_ref(tdy, y.detach(), thr, blk)
    np.testing.assert_array_equal(_tbits(bwd), _tbits(got))
    if thr <= 0:
        np.testing.assert_array_equal(_tbits(got), _tbits(tdy))


def test_output_mask_equals_input_mask_at_the_threshold():
    """Blocks whose max |x| sits exactly at, just under and just over the
    threshold, and a NaN block: keep(y) == keep(x) block by block, so the
    backward's mask from the output is the forward's."""
    thr = np.float32(0.15)
    below = np.nextafter(thr, np.float32(0))
    above = np.nextafter(thr, np.float32(1))
    x = np.array([[thr, 0.0, -below, below, above, -0.01, np.nan, 1.0,
                   -thr, 0.0, 0.0, 0.0]], np.float32)
    tx = torch.from_numpy(x)
    y = ref.block_act_prune_ref(tx, 0.15, 2)
    keep_x = ref._keep(tx, 0.15, 2)
    keep_y = ref._keep(y, 0.15, 2)
    assert keep_x.flatten().tolist() == [1.0, 0.0, 1.0, 0.0, 1.0, 0.0]
    assert torch.equal(keep_x, keep_y)
    jy = jap.block_act_prune(jnp.asarray(x), 0.15, 2)
    assert np.array_equal(np.isnan(np.asarray(jy)), np.isnan(y.numpy()))
    ok = ~np.isnan(x)
    np.testing.assert_array_equal(_bits(np.asarray(jy))[ok], _tbits(y)[ok])


@pytest.mark.parametrize("thr,blk", [(0.15, 2), (0.3, 4)])
def test_block_sparsity_matches_reference(thr, blk):
    x = (np.random.default_rng(7).normal(size=(3, 5, 5, 32)) * 0.25) \
        .astype(np.float32)
    want = float(jap.block_sparsity(jnp.asarray(x), thr, blk))
    got = float(pap.block_sparsity(torch.from_numpy(x), thr, blk))
    assert got == want and 0 < got < 1


@pytest.mark.parametrize("bad", ["block", "contiguity", "dtype", "bwd_shape"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x = torch.randn(4, 8, 16)
    counts = ops.launch_counts()
    with pytest.raises(ValueError):
        if bad == "block":
            ops.block_act_prune_fwd(torch.randn(4, 6), 0.15, 4)
        elif bad == "contiguity":
            ops.block_act_prune_fwd(x.transpose(0, 1), 0.15, 2)
        elif bad == "dtype":
            ops.block_act_prune_fwd(x.double(), 0.15, 2)
        else:
            ops.block_act_prune_bwd(x, x[:2], 0.15, 2)
    assert ops.launch_counts() == counts   # the CPU launches nothing


def test_cpu_dispatch_counts_no_launch():
    before = ops.launch_counts()
    x = torch.randn(2, 4, 4, 8, requires_grad=True)
    pap.block_act_prune(x).sum().backward()
    assert ops.launch_counts() == before
    assert {"block_act_prune", "block_act_prune_bwd"} <= set(before)
