"""The block scatter-update's two modes on the CPU: out of place (`out=`
given) against the reference's TPU kernel (interpret mode) and oracle,
duplicate block indices (the highest j wins, as the TPU kernel's sequential
j axis gives), the checks on `out`, and the scatter probe's edits of the
CUDA source.

Every comparison is exact: the scatter routes values and casts them to the
weight's type. The CUDA kernel itself runs only on the card (`python3
chip_smoke.py` holds both modes bitwise against the same plain version
there)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.scatter_blocks import block_scatter_update_kernel  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import sparse_update as P  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402


def _np(a):
    return np.asarray(a, np.float32)


def _inputs(rng, k, r, s, nb, blk, n_sel, dtype, replace=False):
    n = s * nb * blk
    w = jnp.asarray(rng.normal(size=(k, r, n)), dtype)
    upd = jnp.asarray(rng.normal(size=(k, r, s, n_sel, blk)), jnp.float32)
    idx = np.stack([rng.choice(nb, n_sel, replace=replace)
                    for _ in range(k * s)]).reshape(k, s, n_sel)
    return w, upd, idx.astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k_steps", [1, 3])
@pytest.mark.parametrize("n_shards", [1, 2])
@pytest.mark.parametrize("r,nb,blk,n_sel,tr", [
    (32, 8, 8, 3, 32),        # odd n_sel
    (64, 4, 16, 2, 32),
    (16, 2, 128, 1, 16),      # the training path's channel block
    (48, 6, 8, 6, 16),        # full selection: every block overwritten
])
def test_out_of_place_wrapper_matches_tpu_kernel(dtype, k_steps, n_shards, r,
                                                 nb, blk, n_sel, tr):
    """`out=` given: out == interpret-mode TPU kernel == reference oracle,
    bit for bit, and w keeps every bit."""
    rng = np.random.default_rng(r * 5 + nb + k_steps * n_shards)
    w, upd, idx = _inputs(rng, k_steps, r, n_shards, nb, blk, n_sel, dtype)
    want = block_scatter_update_kernel(w, upd.astype(w.dtype), idx, tr=tr,
                                       interpret=True)
    oracle = jref.block_scatter_update_ref(w, upd, idx, blk)
    tw, tu, ti = (bridge.to_torch(np.asarray(a)) for a in (w, upd, idx))
    before = tw.clone()
    spec = P.SelSpec(block=blk, n_shards=n_shards, n_sel=n_sel, n_blocks=nb)
    out = torch.full_like(tw, 7.0)
    got = ops.block_scatter_update(tw, tu, ti, spec, out=out)
    assert got is out and out.dtype == tw.dtype
    np.testing.assert_array_equal(_np(bridge.to_numpy(out)), _np(want))
    np.testing.assert_array_equal(_np(bridge.to_numpy(out)), _np(oracle))
    assert torch.equal(tw.view(torch.uint8), before.view(torch.uint8))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", range(3))
def test_duplicate_indices_highest_j_wins(dtype, seed):
    """idx[k, s] naming a block twice or more: the plain version and both
    modes of the wrapper == the interpret-mode TPU kernel, whose j axis
    runs in order, so the last (highest) j's values stay."""
    rng = np.random.default_rng(100 + seed)
    k, r, s, nb, blk, n_sel = 2, 16, 2, 3, 8, 5    # 5 picks of 3 blocks
    w, upd, idx = _inputs(rng, k, r, s, nb, blk, n_sel, dtype, replace=True)
    idx[0, 0] = [1, 1, 0, 1, 2]                    # block 1 three times
    want = _np(block_scatter_update_kernel(w, upd.astype(w.dtype), idx,
                                           tr=16, interpret=True))
    tw, tu, ti = (bridge.to_torch(np.asarray(a)) for a in (w, upd, idx))
    np.testing.assert_array_equal(
        _np(bridge.to_numpy(ref.block_scatter_update_ref(tw, tu, ti, blk))),
        want)
    # block 1 of (k 0, shard 0) holds j = 3's values
    np.testing.assert_array_equal(
        want[0, :, blk:2 * blk], _np(upd.astype(w.dtype))[0, :, 0, 3])
    spec = P.SelSpec(block=blk, n_shards=s, n_sel=n_sel, n_blocks=nb)
    out = ops.block_scatter_update(tw, tu, ti, spec, out=torch.empty_like(tw))
    np.testing.assert_array_equal(_np(bridge.to_numpy(out)), want)
    ops.block_scatter_update(tw, tu, ti, spec)
    np.testing.assert_array_equal(_np(bridge.to_numpy(tw)), want)


def test_out_equal_to_w_is_in_place():
    """`out=w` is the in-place mode: the same tensor back, the same bits as
    `out=None`."""
    rng = np.random.default_rng(7)
    w, upd, idx = _inputs(rng, 2, 8, 1, 4, 8, 2, "bfloat16")
    tw, tu, ti = (bridge.to_torch(np.asarray(a)) for a in (w, upd, idx))
    spec = P.SelSpec(block=8, n_shards=1, n_sel=2, n_blocks=4)
    twin = tw.clone()
    assert ops.block_scatter_update(tw, tu, ti, spec, out=tw) is tw
    ops.block_scatter_update(twin, tu, ti, spec)
    assert torch.equal(tw.view(torch.int16), twin.view(torch.int16))


@pytest.mark.parametrize("bad", ["shape", "dtype", "device", "contiguity",
                                 "overlap"])
def test_out_checks_raise(bad):
    rng = np.random.default_rng(3)
    w, upd, idx = _inputs(rng, 2, 4, 1, 4, 8, 2, "float32")
    tw, tu, ti = (bridge.to_torch(np.asarray(a)) for a in (w, upd, idx))
    spec = P.SelSpec(block=8, n_shards=1, n_sel=2, n_blocks=4)
    if bad == "shape":
        out = torch.empty((2, 4, 64))
    elif bad == "dtype":
        out = torch.empty(tw.shape, dtype=torch.bfloat16)
    elif bad == "device":
        out = torch.empty(tw.shape, device="meta")
    elif bad == "contiguity":
        out = torch.empty((2, 32, 4)).transpose(1, 2)
    else:                          # w's second half and one row past it
        buf = torch.empty(2 * tw.numel())
        tw = buf[: tw.numel()].view(tw.shape).copy_(tw)
        out = buf[tw.numel() // 2: tw.numel() // 2 + tw.numel()].view(
            tw.shape)
    before = tw.clone()
    with pytest.raises(ValueError):
        ops.block_scatter_update(tw, tu, ti, spec, out=out)
    assert torch.equal(tw, before)


def test_scatter_probe_edits_apply_to_the_shipped_source():
    """`launch/scatter_probe.py` undoes design choices by editing the CUDA
    source's text: every edit must find its text exactly once, or the probe
    cannot build on the card."""
    from repro_torch.launch import scatter_probe
    src = scatter_probe.SRC.read_text()
    for name, edits in scatter_probe.VARIANTS.items():
        for old, _ in edits:
            assert src.count(old) == 1, (name, old)
        assert (scatter_probe.edit(src, edits, name) != src) == bool(edits)
    assert "block_scatter_update_launch" in scatter_probe.OLD.read_text()
