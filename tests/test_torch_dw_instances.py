"""The dW wrappers' choice of instance, and their CPU results at the edge
shapes of the TMA + wgmma tiling.

On the card a bf16 call whose rows, block and bases suit TMA takes the
pipelined (TMA + wgmma) instance and every other call the grid one;
`kops.dw_instance` makes that choice from the arguments alone, so it is
tested here as a pure function. The kernels themselves run only on the card
(`python3 chip_smoke.py` holds both instances against the plain versions
there); on CPU tensors the wrappers run the plain versions, held here
against the reference's grid kernels (interpret mode) and oracles."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from repro_torch.testing import limit_threads  # noqa: E402

limit_threads()
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.batched_dw import batched_dw_kernel  # noqa: E402
from repro.kernels.masked_dw import block_sparse_dw_kernel  # noqa: E402
from repro_torch.core.sparse_update import SelSpec  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,k,n,block,x_off,dy_off,want", [
    (BF16, 4096, 14336, 128, 0, 0, "pipelined"),   # the LM leaves
    (F32, 4096, 14336, 128, 0, 0, "grid"),         # fp32: exact products
    (BF16, 4096, 4096, 8, 0, 0, "grid"),           # a serving wave's block
    (BF16, 2048, 1408, 64, 0, 0, "pipelined"),     # block 64: one TMA box
    (BF16, 4100, 14336, 128, 0, 0, "grid"),        # K rows not 16 bytes
    (BF16, 4096, 14340, 128, 0, 0, "grid"),        # N likewise
    (BF16, 4096, 14336, 128, 2, 0, "grid"),        # x one element off
    (BF16, 4096, 14336, 128, 0, 2, "grid"),        # dy one element off
    (BF16, 4096, 13824, 96, 0, 0, "grid"),         # block no multiple of 64
])
def test_dw_instance_is_a_function_of_the_arguments(dtype, k, n, block,
                                                    x_off, dy_off, want):
    base = 1 << 20    # a 16-byte-aligned address
    assert kops.dw_instance(dtype, k, n, block, base + x_off,
                            base + dy_off) == want


@pytest.mark.parametrize("dtype,block,offset,fits", [
    (BF16, 128, 0, True), (F32, 128, 0, False), (BF16, 8, 0, False),
    (BF16, 128, 1, False)])
def test_forcing_the_pipelined_instance_is_refused_where_it_cannot_run(
        dtype, block, offset, fits):
    """`use_pipelined` reads the tensors' own dtype, widths and base
    addresses: None picks the instance, True raises ValueError where only
    the grid instance can take the call, False always takes the grid."""
    m, k, n = 16, 64, 4 * block
    x = torch.zeros(m * k + offset, dtype=dtype)[offset:].view(m, k)
    dy = torch.zeros(m * n, dtype=dtype).view(m, n)
    assert kops.use_pipelined(x, dy, block) is fits
    assert kops.use_pipelined(x, dy, block, False) is False
    if fits:
        assert kops.use_pipelined(x, dy, block, True) is True
    else:
        with pytest.raises(ValueError):
            kops.use_pipelined(x, dy, block, True)


def _idx_last_selected(rng, n_shards, n_blocks, n_sel):
    """Distinct indices per shard, the last shard's last block selected."""
    idx = np.stack([rng.choice(n_blocks, n_sel, replace=False)
                    for _ in range(n_shards)]).astype(np.int32)
    if n_blocks - 1 not in idx[-1]:
        idx[-1, -1] = n_blocks - 1
    return idx


def _t(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


# (m, fan-in, n_shards, n_blocks, n_sel, block): two shards; a compact width
# (n_shards * n_sel * block = 192) that leaves the last 128-column tile half
# full; fan-in 24 (one ragged row tile) and 136 (a second, 8 rows deep).
# Then the seams of the grid instance's packed 128-column tile: block 8 at
# M = 16 (a serving wave) with compact widths of 104 and 144 (no multiple
# of 128; the second straddles a shard boundary at column 72 and a tile
# boundary); 16-column blocks whose first tile straddles the shard
# boundary at column 80, the last block selected; block 96, where the
# first tile ends 32 columns into the second selected block.
DENSE_CASES = [(40, 24, 2, 3, 2, 64), (64, 136, 1, 4, 3, 64),
               (24, 24, 1, 2, 1, 128),
               (16, 24, 1, 20, 13, 8), (16, 40, 2, 12, 9, 8),
               (32, 24, 2, 6, 5, 16), (40, 136, 1, 3, 2, 96)]
# (experts, capacity, fan-in, n_shards, n_blocks, n_sel, block): a capacity
# that is no multiple of 8, as an expert's 481 is not; capacity 17 at block
# 8 over two shards (compact width 112)
BATCHED_CASES = [(3, 17, 24, 2, 3, 2, 64), (2, 70, 136, 1, 4, 3, 64),
                 (4, 17, 40, 2, 10, 7, 8)]


@pytest.mark.parametrize("against", ["grid_kernel", "oracle"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n_shards,nb,n_sel,block", DENSE_CASES)
def test_block_sparse_dw_edge_shapes_match_reference(against, dtype, m, k,
                                                     n_shards, nb, n_sel,
                                                     block):
    """The wrapper on CPU tensors (`pipelined=True` is ignored there)
    against the TPU grid kernel (interpret mode, tm = M, tk = K) and the
    reference's oracle. Tolerance 1e-5 in both dtypes: bf16 inputs are exact
    in fp32 and both sides sum in fp32, so only the order differs."""
    rng = np.random.default_rng(m * 131 + k)
    n = n_shards * nb * block
    x = rng.normal(size=(m, k)).astype(np.float32)
    dy = rng.normal(size=(m, n)).astype(np.float32)
    idx = _idx_last_selected(rng, n_shards, nb, n_sel)
    jdt = getattr(jnp, dtype)
    jx, jdy, jidx = jnp.asarray(x, jdt), jnp.asarray(dy, jdt), \
        jnp.asarray(idx)
    if against == "grid_kernel":
        want = block_sparse_dw_kernel(jx, jdy, jidx, block=block, tm=m, tk=k,
                                      interpret=True)
    else:
        want = jref.block_sparse_dw_ref(jx, jdy, jidx, block)
    spec = SelSpec(block=block, n_shards=n_shards, n_sel=n_sel, n_blocks=nb)
    tdt = getattr(torch, dtype)
    got = kops.block_sparse_dw(_t(x, tdt), _t(dy, tdt),
                               torch.from_numpy(idx), spec, pipelined=True)
    assert tuple(got.shape) == (k, n_shards, n_sel, block)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("against", ["grid_kernel", "oracle"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e,c,k,n_shards,nb,n_sel,block", BATCHED_CASES)
def test_batched_dw_edge_shapes_match_reference(against, dtype, e, c, k,
                                                n_shards, nb, n_sel, block):
    """As above for the expert-batched wrapper: one selection for all E
    experts, each expert's rows summed apart (the reference's per-expert
    oracle and its batched grid kernel with tm = C)."""
    rng = np.random.default_rng(e * 977 + c)
    n = n_shards * nb * block
    x = rng.normal(size=(e, c, k)).astype(np.float32)
    dy = rng.normal(size=(e, c, n)).astype(np.float32)
    idx = _idx_last_selected(rng, n_shards, nb, n_sel)
    jdt = getattr(jnp, dtype)
    jx, jdy, jidx = jnp.asarray(x, jdt), jnp.asarray(dy, jdt), \
        jnp.asarray(idx)
    if against == "grid_kernel":
        want = batched_dw_kernel(jx, jdy, jidx, block=block, tm=c, tk=k,
                                 interpret=True)
    else:
        want = jnp.stack([jref.block_sparse_dw_ref(jx[i], jdy[i], jidx,
                                                   block)
                          for i in range(e)])
    spec = SelSpec(block=block, n_shards=n_shards, n_sel=n_sel, n_blocks=nb)
    tdt = getattr(torch, dtype)
    got = kops.block_sparse_dw_batched(_t(x, tdt), _t(dy, tdt),
                                       torch.from_numpy(idx), spec,
                                       pipelined=True)
    assert tuple(got.shape) == (e, k, n_shards, n_sel, block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_dw_probe_variants_apply_to_the_shipped_source():
    """`launch/dw_probe.py` undoes design choices by editing the CUDA
    source's text (old_grid splices `launch/dw_old_grid.cuh` in): every
    edit must find its text exactly once, or the probe cannot build on the
    card."""
    from repro_torch.kernels import build
    from repro_torch.launch import dw_probe
    src = (build.CSRC / "block_sparse_dw.cu").read_text()
    for name in dw_probe.VARIANTS:
        edits = dw_probe.edits_of(name)
        for old, _ in edits:
            assert src.count(old) == 1, (name, old)
        assert dw_probe._edit(src, edits, name) != src or not edits
