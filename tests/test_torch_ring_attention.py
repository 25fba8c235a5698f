"""The port's sliding-window serving attention and flash-decoding softmax
against the reference's (`repro.models.layers`): windowed
`decode_attention` over a wrapping ring, `chunk_ring_attention` (a wrap
inside a chunk, padded rows, an inactive row, a window longer than the
ring), `decoding._ring_pack`, and `_grouped_scores_split` against the
reference's and against the monolithic softmax on the reference's four
shapes (tests/test_serve_sharded.py).

Params: one attention layer of the gemma3-4b smoke config from the
reference's init, bridged; inputs are numpy arrays made from a seed. f32
throughout: outputs and ring contents within 1e-5 of max(1, the largest
value) (sums in another order), ring slots that nothing writes bitwise,
the split softmax within 1e-6."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from repro_torch.testing import limit_threads  # noqa: E402

limit_threads()
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jget  # noqa: E402
from repro.models import decoding as JD  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_smoke_config as pget  # noqa: E402
from repro_torch.models import decoding as PD  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402

ARCH = "gemma3-4b"


def _attn(seed=0):
    cfg = jget(ARCH)
    p = jax.device_get(JL.init_attention(jax.random.PRNGKey(seed), cfg,
                                         jnp.float32))
    return cfg, pget(ARCH), p, bridge.to_torch(p)


def _close(got, want, tol, what=""):
    got = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max abs err {err} > {tol * scale}"


def _normal(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("window,s_cache", [(4, 4), (6, 6), (16, 10)],
                         ids=["ring4", "ring6", "window-over-ring"])
def test_decode_attention_window_matches_reference(window, s_cache):
    """Rows at positions before, at and past the ring's first wrap, one
    decode step each, for 7 steps: output, ring and pos."""
    jcfg, pcfg, jp, tp = _attn()
    rng = np.random.default_rng(1)
    b, hkv, hd = 3, jcfg.num_kv_heads, jcfg.resolved_head_dim
    cache = {"k": _normal(rng, (b, s_cache, hkv, hd)),
             "v": _normal(rng, (b, s_cache, hkv, hd)),
             "pos": np.array([0, s_cache - 1, s_cache + 3], np.int32)}
    jc, pc = jax.tree.map(jnp.asarray, cache), bridge.to_torch(cache)
    for step in range(7):
        x = _normal(rng, (b, 1, jcfg.d_model))
        pos = np.array(jc["pos"])[:, None]
        jy, jc = JL.decode_attention(jp, jcfg, jnp.asarray(x),
                                     jnp.asarray(pos), jc, window=window)
        py, pc = PL.decode_attention(tp, pcfg, torch.from_numpy(x),
                                     torch.from_numpy(pos), pc, window=window)
        _close(py, jy, 1e-5, f"step {step} y")
        for key in ("k", "v"):
            _close(pc[key], jc[key], 1e-5, f"step {step} {key}")
        np.testing.assert_array_equal(pc["pos"].numpy(), np.asarray(jc["pos"]))


def _ring_case(rng, jcfg, b, w_cap, s):
    hkv, hd = jcfg.num_kv_heads, jcfg.resolved_head_dim
    ring = {"k": _normal(rng, (b, w_cap, hkv, hd)),
            "v": _normal(rng, (b, w_cap, hkv, hd))}
    x = _normal(rng, (b, s, jcfg.d_model))
    return ring, x


CASES = ["wrap", "padded", "inactive", "window-over-ring", "long-chunk"]


@pytest.mark.parametrize("case", CASES)
def test_chunk_ring_attention_matches_reference(case):
    """Rows at different depths (0, mid-ring, past several wraps), chunks
    of 4 (or 9, longer than the ring) with per-row valid lengths: the
    output and the new ring. Padded rows and the inactive row leave their
    ring slots bitwise; of the valid rows only the last W land."""
    jcfg, pcfg, jp, tp = _attn()
    rng = np.random.default_rng(CASES.index(case))
    b = 3
    w_cap, window, s = {"wrap": (4, 4, 4), "padded": (6, 6, 4),
                        "inactive": (4, 4, 4),
                        "window-over-ring": (10, 16, 4),
                        "long-chunk": (4, 4, 9)}[case]
    ring, x = _ring_case(rng, jcfg, b, w_cap, s)
    start = np.array([0, 3, 13], np.int32)
    length = np.full(b, s, np.int32)
    if case in ("padded", "long-chunk"):
        length = np.array([s, 1, s - 2], np.int32)
    active = np.array([True, case != "inactive", True])
    jy, jring = JL.chunk_ring_attention(
        jp, jcfg, jnp.asarray(x), jnp.asarray(start), jnp.asarray(active),
        jax.tree.map(jnp.asarray, ring), window=window,
        length=jnp.asarray(length))
    py, pring = PL.chunk_ring_attention(
        tp, pcfg, torch.from_numpy(x), torch.from_numpy(start),
        torch.from_numpy(active), bridge.to_torch(ring), window=window,
        length=torch.from_numpy(length))
    # a row's output at a padded position is garbage on both sides (its
    # keys are masked only for later rows): compare the valid ones
    valid = np.arange(s)[None, :] < length[:, None]
    _close(py.numpy()[valid], np.asarray(jy)[valid], 1e-5, "y")
    for key in ("k", "v"):
        _close(pring[key], jring[key], 1e-5, key)
        written = np.zeros((b, w_cap), bool)
        for r in range(b):
            if active[r]:
                for p in range(start[r] + max(0, length[r] - w_cap),
                               start[r] + length[r]):
                    written[r, p % w_cap] = True
        np.testing.assert_array_equal(pring[key].numpy()[~written],
                                      ring[key][~written])


@pytest.mark.parametrize("s,window", [(3, 8), (8, 8), (11, 4), (20, 6)])
def test_ring_pack_matches_reference(s, window):
    rng = np.random.default_rng(s)
    k = _normal(rng, (2, s, 2, 4))
    want = JD._ring_pack(jnp.asarray(k), window)
    got = PD._ring_pack(torch.from_numpy(k), window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("b,s,hq,hkv,hd,L_kv,tile", [
    (2, 1, 4, 2, 8, 13, 4),     # batched decode row, L not a tile multiple
    (1, 4, 8, 4, 8, 16, 4),     # prefill chunk, exact tiling
    (3, 4, 4, 4, 16, 7, 8),     # MHA, single ragged tile
    (2, 1, 8, 2, 8, 21, 4),     # deep GQA grouping
])
def test_grouped_scores_split_matches_reference(b, s, hq, hkv, hd, L_kv,
                                                tile):
    """The page-tiled online softmax against the reference's and against
    the monolithic softmax, on the reference's own shapes and mask."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((b, s, hq, hd)).astype(np.float32)
    k = rng.standard_normal((b, L_kv, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((b, L_kv, hkv, hd)).astype(np.float32)
    mask = rng.random((b, s, L_kv)) > 0.4
    mask[:, :, 0] = True                   # every query has >= 1 valid key
    want = JL._grouped_scores_split(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.asarray(mask), tile)
    tq, tk, tv, tm = (torch.from_numpy(a) for a in (q, k, v, mask))
    got = PL._grouped_scores_split(tq, tk, tv, tm, tile)
    mono = PL._grouped_scores(tq, tk, tv, tm)
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) < 1e-6
    assert float((got - mono).abs().max()) < 1e-6


def test_ring_cache_sizes_match_reference():
    """init_kv_cache(window=) and ring_snapshot_leaves: min(window,
    seq_len) slots."""
    jcfg, pcfg, _, _ = _attn()
    for window, seq in ((16, 40), (16, 10), (0, 12)):
        jc = JL.init_kv_cache(jcfg, 2, seq, window=window)
        pc = PL.init_kv_cache(pcfg, 2, seq, torch.float32, "cpu",
                              window=window)
        assert {k: tuple(v.shape) for k, v in pc.items()} == \
            {k: tuple(v.shape) for k, v in jc.items()}
        if window:
            js = JL.ring_snapshot_leaves(jcfg, window, seq)
            ps = PL.ring_snapshot_leaves(pcfg, window, seq, torch.float32)
            assert {k: v[0] for k, v in ps.items()} == \
                {k: v[0] for k, v in js.items()}
