"""The port's serving model paths against the reference's on the llama3 smoke
config: `delta_matmul_add`, `paged_step` (logits and page pools, across page
boundaries, with padded chunks, inactive rows, unallocated pages and
per-row deltas), `prefill` / `decode_step`, and the cache row ops; plus
chunked prefill + decode against the port's own `forward`.

Params come from the reference's init, bridged; inputs are numpy arrays
made from a seed. f32 runs hold to 1e-5 (sums in another order); the bf16
run to 2e-2 of the largest value: both sides round activations to bf16
after every matmul, norm and residual add, in different orders, so over 3
layers they agree to a few bf16 ulps (2^-8 relative each)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import common as JC  # noqa: E402
from repro.models import decoding as JD  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import common as PC  # noqa: E402
from repro_torch.models import decoding as PD  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402

PS = 4            # page size
MAX_LEN = 16
NUM_PAGES = 8
LEAVES = {"attn": ("wq", "wk", "wv", "wo"),
          "mlp": ("w_gate", "w_up", "w_down")}


def _setup(dtype="float32", seed=0):
    jcfg = dataclasses.replace(jget_smoke("llama3-8b"), dtype=dtype)
    pcfg = dataclasses.replace(get_smoke_config("llama3-8b"), dtype=dtype)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, pcfg, jparams, bridge.to_torch(jax.device_get(jparams))


def _np32(a):
    if isinstance(a, torch.Tensor):
        a = bridge.to_numpy(a)
    return np.asarray(a, np.float32)


def _close(got, want, tol, what=""):
    got, want = _np32(got), _np32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= tol * scale, f"{what}: max abs err {err} > {tol * scale}"


def _distinct_idx(rng, lead, n_blocks, n_sel):
    flat = [rng.choice(n_blocks, n_sel, replace=False)
            for _ in range(int(np.prod(lead)))]
    return np.stack(flat).reshape(lead + (n_sel,)).astype(np.int32)


# ---------------------------------------------------------------------------
# delta_matmul_add / last_valid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6),
                                       ("bfloat16", 8e-3)])
def test_delta_matmul_add_matches_reference(dtype, tol):
    """Per-row deltas selecting different blocks: the port's gather / add /
    write-back against the reference's `.at[].add`. bf16: one rounding of
    the fp32 sum to bf16 (2^-8 relative) apart at most."""
    rng = np.random.default_rng(0)
    b, s, d_in = 3, 5, 16
    n_shards, n_blocks, block, n_sel = 2, 4, 8, 2
    n = n_shards * n_blocks * block
    x = rng.normal(size=(b, s, d_in)).astype(np.float32)
    w = rng.normal(size=(d_in, n)).astype(np.float32)
    idx = _distinct_idx(rng, (b, n_shards), n_blocks, n_sel)
    val = rng.normal(size=(b, d_in, n_shards, n_sel, block)).astype(
        np.float32)
    jx = jnp.asarray(x, dtype)
    jy = jx @ jnp.asarray(w, dtype)
    jdelta = {"idx": {"wq": jnp.asarray(idx)}, "val": {"wq": jnp.asarray(val)}}
    want = JC.delta_matmul_add(jy, jx, jdelta, "wq")
    tx, ty = bridge.to_torch(np.asarray(jx)), bridge.to_torch(np.asarray(jy))
    tdelta = {"idx": {"wq": torch.from_numpy(idx)},
              "val": {"wq": torch.from_numpy(val)}}
    got = PC.delta_matmul_add(ty, tx, tdelta, "wq")
    assert got.dtype == ty.dtype
    _close(got, want, tol, "delta_matmul_add")
    assert PC.delta_matmul_add(ty, tx, tdelta, "wo") is ty
    assert PC.delta_matmul_add(ty, tx, None, "wq") is ty


def test_delta_matmul_add_zero_rows_exact_noop():
    """Zero delta rows give y back bitwise through the fp32 round trip: the
    guarantee that lets plain requests share the personalized step."""
    rng = np.random.default_rng(1)
    b, s, d_in, block = 2, 3, 8, 8
    y = torch.from_numpy(rng.normal(size=(b, s, 2 * block)).astype(
        np.float32)).to(torch.bfloat16)
    x = torch.from_numpy(rng.normal(size=(b, s, d_in)).astype(
        np.float32)).to(torch.bfloat16)
    delta = {"idx": {"wq": torch.zeros((b, 1, 1), dtype=torch.int32)},
             "val": {"wq": torch.zeros((b, d_in, 1, 1, block))}}
    out = PC.delta_matmul_add(y, x, delta, "wq")
    assert out.dtype == y.dtype
    assert torch.equal(out.view(torch.int16), y.view(torch.int16))


def test_last_valid_matches_reference():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 5, 4)).astype(np.float32)
    length = np.array([5, 1, 3], np.int32)
    want = JC.last_valid(jnp.asarray(x), jnp.asarray(length))
    got = PC.last_valid(torch.from_numpy(x), torch.from_numpy(length))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(PC.last_valid(torch.from_numpy(x),
                                                None).numpy(), x[:, -1])


# ---------------------------------------------------------------------------
# paged_step against the reference
# ---------------------------------------------------------------------------

def _delta_trees(rng, jparams, steps, b):
    """Random per-row delta trees for every covered leaf of the smoke
    config, [steps, B, ...] (numpy), blocks of 8 and half of them
    selected."""
    idx, val = {}, {}
    for group, names in LEAVES.items():
        idx[group], val[group] = {}, {}
        for name in names:
            d_in, n = jparams["segments"]["blocks"][group][name].shape[1:]
            nb = n // 8
            idx[group][name] = _distinct_idx(rng, (steps, b, 1), nb, nb // 2)
            val[group][name] = (0.05 * rng.normal(
                size=(steps, b, d_in, 1, nb // 2, 8))).astype(np.float32)
    return {"blocks": {"idx": idx, "val": val}}


def _rows(tree, lo, hi):
    """Rows [lo, hi) of a [steps, B, ...] tree (numpy)."""
    if isinstance(tree, dict):
        return {k: _rows(v, lo, hi) for k, v in tree.items()}
    return tree[:, lo:hi]


def _scenario(rng, vocab):
    """(batch row(s), numpy batch) steps over two requests: full and padded
    prefill chunks, page-crossing decodes, an inactive row, and a write
    into an unallocated page (dropped)."""
    t0 = rng.integers(0, vocab, 7).astype(np.int32)
    t1 = rng.integers(0, vocab, 6).astype(np.int32)

    def chunk(toks, start, size):
        pad = np.zeros(PS, np.int32)
        pad[:size] = toks[start:start + size]
        return {"tokens": pad[None], "start": np.array([start], np.int32),
                "active": np.array([True]),
                "length": np.array([size], np.int32)}

    def decode(toks, start, active):
        return {"tokens": np.array(toks, np.int32)[:, None],
                "start": np.array(start, np.int32),
                "active": np.array(active), "length": np.ones(2, np.int32)}

    return [((0, 1), chunk(t0, 0, 4)), ((0, 1), chunk(t0, 4, 3)),
            ((1, 2), chunk(t1, 0, 4)), ((1, 2), chunk(t1, 4, 2)),
            ((0, 2), decode([11, 12], [7, 6], [True, True])),
            ((0, 2), decode([13, 14], [8, 7], [True, False])),
            ((0, 2), decode([15, 16], [9, 8], [True, True]))]


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("with_delta", [False, True],
                         ids=["plain", "delta"])
def test_paged_step_matches_reference(dtype, tol, with_delta):
    """Logits and every layer's page pool after each step, against the
    reference's `paged_step`. Row 1's third page is unallocated, so its
    last decode write is dropped on both sides; row 1 is inactive in the
    second decode and keeps everything."""
    jcfg, pcfg, jparams, tparams = _setup(dtype)
    rng = np.random.default_rng(5)
    steps = jcfg.num_layers
    page_table = np.array([[5, 2, 7, -1], [0, 3, -1, -1]], np.int32)
    deltas = _delta_trees(rng, jparams, steps, 2) if with_delta else None
    jstate, jpools = JD.init_serve_cache(jcfg, 2, MAX_LEN, NUM_PAGES, PS)
    pstate, ppools = PD.init_serve_cache(pcfg, 2, MAX_LEN, NUM_PAGES, PS,
                                         device="cpu")
    jstep = jax.jit(lambda p, b, st, pl, pt, d: JD.paged_step(
        jcfg, p, b, st, pl, pt, page_size=PS, deltas=d))
    for n, ((lo, hi), batch) in enumerate(_scenario(rng, jcfg.vocab_size)):
        d = None if deltas is None else _rows(deltas, lo, hi)
        pt = page_table[lo:hi]
        jl, jstate, jpools = jstep(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jstate,
            jpools, jnp.asarray(pt),
            None if d is None else jax.tree.map(jnp.asarray, d))
        pl, pstate, ppools = PD.paged_step(
            pcfg, tparams, {k: torch.from_numpy(v) for k, v in batch.items()},
            pstate, ppools, torch.from_numpy(pt), page_size=PS,
            deltas=None if d is None else bridge.to_torch(d))
        _close(pl, jl, tol, f"step {n} logits")
        for key in ("k", "v"):
            _close(ppools["blocks"][key], jpools["blocks"][key], tol,
                   f"step {n} pool {key}")


def test_paged_step_does_not_write_its_inputs():
    """The pools passed in stay as they were (the step is functional, as
    the reference's); an inactive row writes nothing into the new pools."""
    _, pcfg, _, tparams = _setup()
    _, pools = PD.init_serve_cache(pcfg, 2, MAX_LEN, NUM_PAGES, PS,
                                   device="cpu")
    batch = {"tokens": torch.tensor([[3], [4]], dtype=torch.int32),
             "start": torch.tensor([0, 0], dtype=torch.int32),
             "active": torch.tensor([True, False]),
             "length": torch.ones(2, dtype=torch.int32)}
    pt = torch.tensor([[1, -1, -1, -1], [2, -1, -1, -1]], dtype=torch.int32)
    _, _, new = PD.paged_step(pcfg, tparams, batch, {}, pools, pt,
                              page_size=PS)
    assert all(bool((a == 0).all()) for a in (pools["blocks"]["k"],
                                              pools["blocks"]["v"]))
    k = new["blocks"]["k"]
    assert k.shape == pools["blocks"]["k"].shape
    assert bool((k[:, PS:PS + 1] != 0).any())          # row 0, page 1
    assert bool((k[:, 2 * PS:3 * PS] == 0).all())      # row 1 inactive


# ---------------------------------------------------------------------------
# prefill / decode_step
# ---------------------------------------------------------------------------

def test_prefill_and_decode_step_match_reference():
    jcfg, pcfg, jparams, tparams = _setup()
    rng = np.random.default_rng(7)
    b, s0, s = 2, 6, 10
    toks = rng.integers(0, jcfg.vocab_size, (b, s)).astype(np.int32)
    jl, jcache = JD.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks[:, :s0])},
                            pad_to=s)
    pl, pcache = PD.prefill(pcfg, tparams,
                            {"tokens": torch.from_numpy(toks[:, :s0])},
                            pad_to=s)
    _close(pl, jl, 1e-5, "prefill logits")
    for key in ("k", "v", "pos"):
        _close(pcache["blocks"][key], jcache["blocks"][key], 1e-5,
               f"prefill cache {key}")
    for t in range(s0, s):
        jb = {"tokens": jnp.asarray(toks[:, t:t + 1]),
              "positions": jnp.full((b, 1), t, jnp.int32)}
        tb = {"tokens": torch.from_numpy(toks[:, t:t + 1]),
              "positions": torch.full((b, 1), t, dtype=torch.int32)}
        jl, jcache = JD.decode_step(jcfg, jparams, jb, jcache)
        pl, pcache = PD.decode_step(pcfg, tparams, tb, pcache)
        _close(pl, jl, 1e-5, f"decode logits t={t}")
        for key in ("k", "v", "pos"):
            _close(pcache["blocks"][key], jcache["blocks"][key], 1e-5,
                   f"decode cache {key} t={t}")


def test_chunked_prefill_and_decode_match_forward():
    """The port against itself: logits of chunked paged prefill (page-sized
    chunks, the last one padded) and of paged decode, and of the contiguous
    prefill + decode_step, equal the full-sequence forward's at every
    position (f32, 1e-5: the same products in other groupings)."""
    _, pcfg, _, tparams = _setup()
    rng = np.random.default_rng(9)
    s, s0 = 14, 10
    toks = torch.from_numpy(rng.integers(0, pcfg.vocab_size, (1, s)).astype(
        np.int32))
    hidden, _ = PT.forward(pcfg, (tparams, None), {"tokens": toks},
                           remat=False)
    ref = hidden @ PT.lm_head_weight(pcfg, (tparams, None))   # [1, s, V]

    _, pools = PD.init_serve_cache(pcfg, 1, MAX_LEN, NUM_PAGES, PS,
                                   device="cpu")
    pt = torch.tensor([[6, 1, 4, 0]], dtype=torch.int32)
    for start in range(0, s0, PS):
        size = min(PS, s0 - start)
        chunk = torch.zeros((1, PS), dtype=torch.int32)
        chunk[0, :size] = toks[0, start:start + size]
        logits, _, pools = PD.paged_step(
            pcfg, tparams, {"tokens": chunk,
                            "start": torch.tensor([start], dtype=torch.int32),
                            "active": torch.tensor([True]),
                            "length": torch.tensor([size],
                                                   dtype=torch.int32)},
            {}, pools, pt, page_size=PS)
        _close(logits, ref[:, start + size - 1], 1e-5, f"chunk at {start}")
    logits_c, cache = PD.prefill(pcfg, tparams, {"tokens": toks[:, :s0]},
                                 pad_to=s)
    _close(logits_c, ref[:, s0 - 1], 1e-5, "contiguous prefill")
    for t in range(s0, s):
        tok = toks[:, t:t + 1]
        logits, _, pools = PD.paged_step(
            pcfg, tparams, {"tokens": tok,
                            "start": torch.tensor([t], dtype=torch.int32),
                            "active": torch.tensor([True])},
            {}, pools, pt, page_size=PS)
        _close(logits, ref[:, t], 1e-5, f"paged decode t={t}")
        logits_c, cache = PD.decode_step(
            pcfg, tparams, {"tokens": tok,
                            "positions": torch.full((1, 1), t,
                                                    dtype=torch.int32)},
            cache)
        _close(logits_c, ref[:, t], 1e-5, f"contiguous decode t={t}")


# ---------------------------------------------------------------------------
# caches and row ops
# ---------------------------------------------------------------------------

def test_serve_cache_layout_matches_reference():
    jcfg, pcfg, _, _ = _setup()
    jstate, jpools = JD.init_serve_cache(jcfg, 3, MAX_LEN, NUM_PAGES, PS)
    pstate, ppools = PD.init_serve_cache(pcfg, 3, MAX_LEN, NUM_PAGES, PS,
                                         device="cpu")
    assert pstate == {"blocks": {}} and jax.tree.leaves(jstate) == []
    for key in ("k", "v"):
        assert tuple(ppools["blocks"][key].shape) == \
            jpools["blocks"][key].shape
    assert PD.has_paged_layers(pcfg) == JD.has_paged_layers(jcfg) is True
    assert PD.has_state_layers(pcfg) == JD.has_state_layers(jcfg) is False
    jc = JD.init_cache(jcfg, 2, MAX_LEN)
    pc = PD.init_cache(pcfg, 2, MAX_LEN, device="cpu")
    for key in ("k", "v", "pos"):
        assert tuple(pc["blocks"][key].shape) == jc["blocks"][key].shape


def test_copy_pool_rows_matches_reference():
    rng = np.random.default_rng(4)
    pools = {"blocks": {"k": rng.normal(size=(3, 32, 2, 4)).astype(
        np.float32), "v": rng.normal(size=(3, 32, 2, 4)).astype(np.float32)}}
    want = JD.copy_pool_rows(jax.tree.map(jnp.asarray, pools), 8, 20, PS)
    got = PD.copy_pool_rows(bridge.to_torch(pools), 8, 20, PS)
    for key in ("k", "v"):
        np.testing.assert_array_equal(got["blocks"][key].numpy(),
                                      np.asarray(want["blocks"][key]))


def test_cache_row_ops_roundtrip():
    """insert / extract / reset on the contiguous cache: the row is written
    whole, the other rows are untouched, reset zeroes it."""
    _, pcfg, _, _ = _setup()
    big = PD.init_cache(pcfg, 4, 32, device="cpu")
    row = {"blocks": {k: torch.full((v.shape[0], 1) + tuple(v.shape[2:]), 3,
                                    dtype=v.dtype)
                      for k, v in PD.init_cache(pcfg, 1, 32,
                                                device="cpu")["blocks"].items()}}
    ins = PD.cache_insert_row(big, row, 2)
    got = PD.cache_extract_row(ins, 2)
    assert all(torch.equal(got["blocks"][k], row["blocks"][k]) for k in row["blocks"])
    assert all(bool((v[:, [0, 1, 3]] == 0).all())
               for v in ins["blocks"].values())
    rst = PD.cache_reset_row(ins, 2)
    assert all(bool((v == 0).all()) for v in rst["blocks"].values())


def test_unported_families_and_helpers_raise():
    moe = get_config("deepseek-moe-16b")
    with pytest.raises(NotImplementedError, match="ROADMAP queue A"):
        PD.init_serve_cache(moe, 1, 16, 1, 16, device="meta")
    ring = dataclasses.replace(get_smoke_config("llama3-8b"),
                               sliding_window=8)
    with pytest.raises(NotImplementedError, match="item 12"):
        PD.has_paged_layers(ring)
    for fn, args in ((PD.read_pool_rows, ({}, 0, 1)),
                     (PD.write_pool_rows, ({}, {}, 0)),
                     (PD.make_sharded_paged_step, ())):
        with pytest.raises(NotImplementedError, match="item 1[34]"):
            fn(*args)
