"""The port's serving caches for every family against the reference's, on
the smoke configs of gemma3-4b (sliding-window rings), rwkv6-3b (recurrent
state, no pages), jamba-1.5-large-398b (mamba state, a paged attention
layer, MoE), deepseek-moe-16b and llama4-scout-17b-a16e (MoE): the cache
layouts and snapshot sizes, `paged_step` over padded prefill chunks,
decode steps and an inactive row (gemma and jamba also with a nonzero
per-row delta), prefill + decode against the port's own forward, and the
engine's greedy tokens against the JAX engine's (`prefix_mode="off"`).

Params come from the reference's init, bridged; inputs are numpy arrays
made from a seed. f32 runs hold to 1e-5 of max(1, the largest value) (sums
in another order); the bf16 run to 3e-2: both sides round activations to
bf16 after every matmul, norm and residual add, in different orders, over
6 layers. Greedy tokens are compared exactly, with every sampled step's
top-2 logit gap probed (a gap under 1e-4 fails loudly rather than on a
flipped token)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_full  # noqa: E402
from repro.configs import get_smoke_config as jget  # noqa: E402
from repro.models import decoding as JD  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.configs import get_smoke_config as pget  # noqa: E402
from repro_torch.core.sparse_update import tree_map  # noqa: E402
from repro_torch.models import decoding as PD  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402

ARCHS = ("gemma3-4b", "rwkv6-3b", "jamba-1.5-large-398b", "deepseek-moe-16b",
         "llama4-scout-17b-a16e")
PS = 4
MAX_LEN = 16
NUM_PAGES = 8
GAP = 1e-4
# gemma's smoke window (16) never wraps in 16 positions: the paged_step
# scenario cuts it to one page so every ring wraps
RING_WINDOW = 4
_MODELS = {}


def _cfgs(arch, dtype="float32", **kw):
    jcfg = dataclasses.replace(jget(arch), dtype=dtype, **kw)
    pcfg = dataclasses.replace(pget(arch), dtype=dtype, **kw)
    if jcfg.moe is not None and "moe" not in kw:
        # no token dropping, as the reference's prefill/decode test
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=8.0))
        pcfg = dataclasses.replace(pcfg, moe=dataclasses.replace(
            pcfg.moe, capacity_factor=8.0))
    return jcfg, pcfg


def _model(arch, dtype="float32", **kw):
    key = (arch, dtype, tuple(sorted(kw.items())))
    if key not in _MODELS:
        jcfg, pcfg = _cfgs(arch, dtype, **kw)
        jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
        _MODELS[key] = (jcfg, pcfg, jparams,
                        bridge.to_torch(jax.device_get(jparams)))
    return _MODELS[key]


def _scenario_kw(arch):
    return {"sliding_window": RING_WINDOW} if arch == "gemma3-4b" else {}


def _np32(a):
    if isinstance(a, torch.Tensor):
        a = bridge.to_numpy(a)
    return np.asarray(a, np.float32)


def _close(got, want, tol, what=""):
    got, want = _np32(got), _np32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= tol * scale, f"{what}: max abs err {err} > {tol * scale}"


def _flat(tree, prefix=""):
    """{path: leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _layout(tree):
    """{path: (shape, dtype name)} of a nested dict of arrays or tensors."""
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in _flat(tree).items()}


def _close_trees(got, want, tol, what):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want), (what, sorted(got), sorted(want))
    for k in want:
        _close(got[k], want[k], tol, f"{what} {k}")


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_cache_layouts_match_reference(arch):
    """init_serve_cache (state and pools) and init_cache: the same tree,
    shapes and dtypes as the reference's, in bf16 (the ring k/v and mamba
    conv tail in the model dtype, the mamba h and rwkv s in fp32)."""
    jcfg, pcfg = _cfgs(arch, "bfloat16")
    jst, jpl = JD.init_serve_cache(jcfg, 3, 12, NUM_PAGES, PS)
    pst, ppl = PD.init_serve_cache(pcfg, 3, 12, NUM_PAGES, PS, device="cpu")
    assert _layout(pst) == _layout(jst)
    assert _layout(ppl) == _layout(jpl)
    assert all(not bool(t.any()) for t in _flat((pst, ppl)[0]).values())
    assert _layout(PD.init_cache(pcfg, 2, 12, device="cpu")) == \
        _layout(JD.init_cache(jcfg, 2, 12))
    assert PD.has_paged_layers(pcfg) == JD.has_paged_layers(jcfg)
    assert PD.has_state_layers(pcfg) == JD.has_state_layers(jcfg)
    for seg in PT.segment_layout(pcfg):
        assert PD._paged_layout(pcfg, seg.kind) == \
            JD._paged_layout(jcfg, seg.kind)


def test_snapshot_row_bytes_match_reference():
    """Every registered LM arch, full and smoke configs, two lengths: the
    bytes of one slot's snapshot, what item 13's prefix caches budget."""
    for arch in ARCH_IDS:
        for jcfg, pcfg in ((jget_full(arch), get_config(arch)),
                           (jget(arch), pget(arch))):
            if jcfg.family == "cnn":
                continue
            for max_len in (64, 4096):
                assert PD.snapshot_row_bytes(pcfg, max_len) == \
                    JD.snapshot_row_bytes(jcfg, max_len), (arch, max_len)
            for role in ("paged", "ring", "state"):
                assert PD.CACHE_FAMILIES[role].role == role


# ---------------------------------------------------------------------------
# paged_step against the reference
# ---------------------------------------------------------------------------

def _delta_trees(rng, jparams, b):
    """Random per-row delta trees [steps, B, ...] (numpy) over every
    covered attn / mlp leaf of the "blocks" segment's sublayers; blocks of
    8, half selected."""
    blocks = jparams["segments"]["blocks"]
    idx, val = {}, {}
    for sub, sp in blocks.items():
        for group in ("attn", "mlp"):
            if group not in sp:
                continue
            idx.setdefault(sub, {})[group] = {}
            val.setdefault(sub, {})[group] = {}
            for name, w in sp[group].items():
                steps, d_in, n = w.shape
                nb = n // 8
                idx[sub][group][name] = np.stack([
                    rng.choice(nb, nb // 2, replace=False)
                    for _ in range(steps * b)]).reshape(
                        steps, b, 1, nb // 2).astype(np.int32)
                val[sub][group][name] = (0.05 * rng.normal(
                    size=(steps, b, d_in, 1, nb // 2, 8))).astype(np.float32)
    return {"blocks": {"idx": idx, "val": val}}


def _rows(tree, lo, hi):
    if isinstance(tree, dict):
        return {k: _rows(v, lo, hi) for k, v in tree.items()}
    return tree[:, lo:hi]


def _scenario(rng, vocab):
    """(rows, numpy batch) steps: row 0 prefills 7 tokens and row 1 6 (a
    full chunk, then a padded one each), three decodes, row 1 inactive in
    the second."""
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


def _run_paged(arch, dtype, tol, with_delta, flash_decode=False):
    jcfg, pcfg, jparams, tparams = _model(arch, dtype, **_scenario_kw(arch))
    rng = np.random.default_rng(5)
    page_table = np.array([[5, 2, 7, -1], [0, 3, 6, -1]], np.int32)
    deltas = _delta_trees(rng, jparams, 2) if with_delta else None
    jst, jpl = JD.init_serve_cache(jcfg, 2, MAX_LEN, NUM_PAGES, PS)
    pst, ppl = PD.init_serve_cache(pcfg, 2, MAX_LEN, NUM_PAGES, PS,
                                   device="cpu")
    jstep = jax.jit(lambda p, b, st, pl, pt, d: JD.paged_step(
        jcfg, p, b, st, pl, pt, page_size=PS, deltas=d,
        flash_decode=flash_decode))
    for n, ((lo, hi), batch) in enumerate(_scenario(rng, jcfg.vocab_size)):
        d = None if deltas is None else _rows(deltas, lo, hi)
        pt = page_table[lo:hi]
        one = hi - lo == 1
        j_in = JD.cache_extract_row(jst, lo) if one else jst
        p_in = PD.cache_extract_row(pst, lo) if one else pst
        jl, j_out, jpl = jstep(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()}, j_in,
            jpl, jnp.asarray(pt),
            None if d is None else jax.tree.map(jnp.asarray, d))
        pl, p_out, ppl = PD.paged_step(
            pcfg, tparams, {k: torch.from_numpy(v) for k, v in batch.items()},
            p_in, ppl, torch.from_numpy(pt), page_size=PS,
            deltas=None if d is None else bridge.to_torch(d),
            flash_decode=flash_decode)
        jst = JD.cache_insert_row(jst, j_out, lo) if one else j_out
        pst = PD.cache_insert_row(pst, p_out, lo) if one else p_out
        _close(pl, jl, tol, f"step {n} logits")
        _close_trees(pst, jst, tol, f"step {n} state")
        _close_trees(ppl, jpl, tol, f"step {n} pools")
    return pst


@pytest.mark.parametrize("arch,with_delta", [
    (a, False) for a in ARCHS] + [("gemma3-4b", True),
                                  ("jamba-1.5-large-398b", True)],
    ids=lambda v: v if isinstance(v, str) else ("delta" if v else "plain"))
def test_paged_step_matches_reference(arch, with_delta):
    """Logits, every state leaf (rings, mamba h / conv, rwkv s / last) and
    every pool after each step: padded chunks leave the state as after the
    valid prefix, gemma's 4-slot rings wrap inside a chunk, the inactive
    row keeps everything."""
    _run_paged(arch, "float32", 1e-5, with_delta)


def test_paged_step_matches_reference_bf16():
    _run_paged("gemma3-4b", "bfloat16", 3e-2, False)


def test_paged_step_inactive_row_keeps_its_state():
    """An inactive row's state leaves come back bitwise (the active-row
    merge), and the step writes none of the state tensors passed in."""
    _, pcfg, _, tparams = _model("jamba-1.5-large-398b")
    st, pl = PD.init_serve_cache(pcfg, 2, MAX_LEN, NUM_PAGES, PS,
                                 device="cpu")
    gen = torch.Generator().manual_seed(0)
    st = tree_map(lambda a: torch.randn(a.shape, generator=gen).to(a.dtype),
                  st)
    before = {k: v.clone() for k, v in _flat(st).items()}
    batch = {"tokens": torch.tensor([[3], [4]], dtype=torch.int32),
             "start": torch.tensor([5, 2], dtype=torch.int32),
             "active": torch.tensor([True, False]),
             "length": torch.ones(2, dtype=torch.int32)}
    pt = torch.tensor([[1, 2, -1, -1], [3, -1, -1, -1]], dtype=torch.int32)
    _, new, _ = PD.paged_step(pcfg, tparams, batch, st, pl, pt, page_size=PS)
    for k, v in _flat(st).items():
        assert torch.equal(v, before[k]), k
    for k, v in _flat(new).items():
        assert torch.equal(v[:, 1], before[k][:, 1]), k
        assert not torch.equal(v[:, 0], before[k][:, 0]), k


# ---------------------------------------------------------------------------
# prefill + decode against the port's own forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_forward(arch):
    """The port against itself, as the reference's test of the same name
    (MoE at capacity 8.0, no token dropped): the contiguous prefill's last
    logits and every decode step's equal the full-sequence forward's, and
    so do chunked paged prefill + paged decode through `paged_step` (f32,
    1e-5: the same products in other groupings)."""
    _, pcfg, _, tparams = _model(arch)
    rng = np.random.default_rng(1)
    b, s, s0 = 2, 14, 10
    toks = torch.from_numpy(rng.integers(0, pcfg.vocab_size, (b, s)).astype(
        np.int32))
    hidden, _ = PT.forward(pcfg, (tparams, None), {"tokens": toks},
                           remat=False)
    ref = hidden @ PT.lm_head_weight(pcfg, (tparams, None))
    logits, cache = PD.prefill(pcfg, tparams, {"tokens": toks[:, :s0]},
                               pad_to=s)
    _close(logits, ref[:, s0 - 1], 1e-5, "prefill")
    for t in range(s0, s):
        logits, cache = PD.decode_step(
            pcfg, tparams, {"tokens": toks[:, t:t + 1],
                            "positions": torch.full((b, 1), t)}, cache)
        _close(logits, ref[:, t], 1e-5, f"decode t={t}")

    state, pools = PD.init_serve_cache(pcfg, 1, MAX_LEN, NUM_PAGES, PS,
                                       device="cpu")
    pt = torch.tensor([[6, 1, 4, 0]], dtype=torch.int32)
    for start in range(0, s0, PS):
        size = min(PS, s0 - start)
        chunk = torch.zeros((1, PS), dtype=torch.int32)
        chunk[0, :size] = toks[0, start:start + size]
        logits, state, pools = PD.paged_step(
            pcfg, tparams, {"tokens": chunk,
                            "start": torch.tensor([start], dtype=torch.int32),
                            "active": torch.tensor([True]),
                            "length": torch.tensor([size],
                                                   dtype=torch.int32)},
            state, pools, pt, page_size=PS)
        _close(logits, ref[:1, start + size - 1], 1e-5, f"chunk {start}")
    for t in range(s0, s):
        logits, state, pools = PD.paged_step(
            pcfg, tparams, {"tokens": toks[:1, t:t + 1],
                            "start": torch.tensor([t], dtype=torch.int32),
                            "active": torch.tensor([True])},
            state, pools, pt, page_size=PS)
        _close(logits, ref[:1, t], 1e-5, f"paged decode t={t}")


def test_short_prompt_mamba_conv_tail():
    """A 2-token prompt, shorter than d_conv - 1 = 3: the prefill's conv
    tail is left-padded with zeros, as the reference's, and one padded
    paged chunk leaves the same tail and h."""
    jcfg, pcfg, jparams, tparams = _model("jamba-1.5-large-398b")
    toks = np.array([[7, 42]], np.int32)
    _, jc = JD.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                       pad_to=8)
    _, pc = PD.prefill(pcfg, tparams, {"tokens": torch.from_numpy(toks)},
                       pad_to=8)
    _close_trees(pc, jc, 1e-5, "prefill cache")
    conv = pc["blocks"]["sub0"]["conv"]
    assert conv.shape[2] == pcfg.ssm.d_conv - 1
    assert not bool(conv[:, :, 0].any()) and bool(conv[:, :, 1:].any())
    state, pools = PD.init_serve_cache(pcfg, 1, 8, 2, PS, device="cpu")
    chunk = torch.zeros((1, PS), dtype=torch.int32)
    chunk[0, :2] = torch.from_numpy(toks[0])
    _, state, _ = PD.paged_step(
        pcfg, tparams, {"tokens": chunk, "start": torch.tensor([0]),
                        "active": torch.tensor([True]),
                        "length": torch.tensor([2], dtype=torch.int32)},
        state, pools, torch.tensor([[0, 1]], dtype=torch.int32),
        page_size=PS)
    for sub in ("sub0", "sub1"):
        for key in ("conv", "h"):
            _close(state["blocks"][sub][key], pc["blocks"][sub][key], 1e-5,
                   f"{sub} {key}")


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

def _probed(engine):
    """Record every sampled step's top-2 logit gap (all rows)."""
    gaps, sample = [], engine._sample

    def probe(logits):
        top = torch.topk(logits.float(), 2, dim=-1).values
        gaps.extend((top[:, 0] - top[:, 1]).tolist())
        return sample(logits)
    engine._sample = probe
    return gaps


def _requests(R, specs, vocab, seed=11):
    rng = np.random.default_rng(seed)
    return [R(rid, gen, tokens=rng.integers(0, vocab, plen).astype(np.int32))
            for rid, (plen, gen) in enumerate(specs)]


# prompts of PAGE-1, PAGE and PAGE+1 tokens over 2 slots: the third
# request refills a used slot
ENGINE_SPECS = [(PS - 1, 5), (PS, 4), (PS + 1, 5)]


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_reference(arch):
    """Greedy tokens and counts of the port's engine equal the JAX
    engine's at pages of 4 (`prefix_mode="off"`); rwkv allocates no
    pages."""
    jcfg, pcfg, jparams, tparams = _model(arch)
    kw = dict(num_slots=2, max_len=12, page_size=PS)
    ref = JServeEngine(jcfg, jparams, prefix_mode="off", **kw).run(
        _requests(JRequest, ENGINE_SPECS, jcfg.vocab_size))
    peng = ServeEngine(pcfg, tparams, **kw)
    gaps = _probed(peng)
    ours = peng.run(_requests(Request, ENGINE_SPECS, pcfg.vocab_size))
    assert gaps and min(gaps) > GAP, f"near-tie: top-2 gap {min(gaps)}"
    assert {k: r.tokens for k, r in ours.results.items()} == \
        {k: r.tokens for k, r in ref.results.items()}
    for field in ("requests_completed", "tokens_out", "refills",
                  "prefill_chunks", "pages_total", "pages_peak"):
        assert getattr(ours, field) == getattr(ref, field), field
    assert ours.refills == 1
    if arch == "rwkv6-3b":
        assert ours.pages_total == ours.pages_peak == 0


def _oracle(cfg, params, toks, gen, max_len):
    """Contiguous prefill + decode_step greedy tokens."""
    logits, cache = PD.prefill(cfg, params,
                               {"tokens": torch.from_numpy(toks)[None]},
                               pad_to=max_len)
    out = [int(logits.argmax(-1)[0])]
    for t in range(len(toks), len(toks) + gen - 1):
        logits, cache = PD.decode_step(
            cfg, params, {"tokens": torch.tensor([[out[-1]]]),
                          "positions": torch.full((1, 1), t)}, cache)
        out.append(int(logits.argmax(-1)[0]))
    return out


def test_gemma_window_longer_than_max_len():
    """gemma's 16-token window over requests of at most 12 positions: every
    ring is 12 slots (min(window, max_len)), never wraps, and the engine's
    tokens equal the contiguous oracle's."""
    _, pcfg, _, tparams = _model("gemma3-4b")
    assert pcfg.sliding_window > 12
    state, _ = PD.init_serve_cache(pcfg, 2, 12, NUM_PAGES, PS, device="cpu")
    assert state["blocks"]["sub0"]["k"].shape[2] == 12
    eng = ServeEngine(pcfg, tparams, num_slots=2, max_len=12, page_size=PS)
    gaps = _probed(eng)
    specs = [(7, 5), (5, 4)]
    reqs = _requests(Request, specs, pcfg.vocab_size, seed=3)
    stats = eng.run(reqs)
    assert min(gaps) > GAP, f"near-tie: top-2 gap {min(gaps)}"
    for r in reqs:
        assert stats.results[r.rid].tokens == _oracle(
            pcfg, tparams, r.tokens, r.max_new_tokens, 12), r.rid


def test_flash_decode_engine_tokens_equal_default():
    """llama3-8b smoke: the page-by-page softmax serves the same greedy
    tokens as the monolithic one, and a flash-decode paged step holds the
    reference's within 1e-5."""
    _, pcfg, _, tparams = _model("llama3-8b")
    specs = [(PS - 1, 6), (2 * PS + 1, 5), (3 * PS, 4)]
    runs = []
    for fd in (False, True):
        eng = ServeEngine(pcfg, tparams, num_slots=2, max_len=18,
                          page_size=PS, flash_decode=fd)
        assert eng.flash_decode is fd
        gaps = _probed(eng)
        runs.append(eng.run(_requests(Request, specs, pcfg.vocab_size)))
        assert min(gaps) > GAP, f"near-tie: top-2 gap {min(gaps)}"
    assert {k: r.tokens for k, r in runs[0].results.items()} == \
        {k: r.tokens for k, r in runs[1].results.items()}
    _run_paged("llama3-8b", "float32", 1e-5, False, flash_decode=True)
