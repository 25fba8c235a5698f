"""Prefix reuse in the port's serve engine (`prefix_mode="radix"`, the
default, and the `"chain"` baseline) against the reference's engine on the
smoke configs of llama3-8b, gemma3-4b, rwkv6-3b, jamba-1.5-large-398b and
deepseek-moe-16b (f32, the reference's params bridged): on the reference
tests' shared-prefix workload the same greedy tokens and the same prefix,
snapshot, spill, page and chunk counts; radix tokens equal the port's own
`off` tokens, with gemma's rings also cut below the prompt so they wrap
before a snapshot boundary. Then the reference's engine-level prefix tests
(`tests/test_serve.py`) on the port, spill-tier files read across the two
frameworks, the request generators and the serve CLI's prefix flags.

MoE layers run with the capacity factor at E / k, so no choice is dropped:
radix changes which tokens share a prefill chunk or decode step, and a
capacity limit would make routing depend on that. Greedy tokens are
compared exactly, with every sampled step's top-2 logit gap probed (under
1e-4 fails loudly rather than on a flipped token)."""
import argparse
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from repro_torch.testing import limit_threads  # noqa: E402

limit_threads()
jax = pytest.importorskip("jax")

from repro.checkpoint import manager as JM  # noqa: E402
from repro.configs import get_smoke_config as jget  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro.serve import engine as JE  # noqa: E402
from repro.serve import paging as JP  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import manager as PM  # noqa: E402
from repro_torch.configs import get_smoke_config as pget  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import decoding as PD  # noqa: E402
from repro_torch.serve import (Request, ServeEngine, SpillTier,  # noqa: E402
                               make_branching_prefix_requests,
                               make_shared_prefix_requests)
from repro_torch.serve import engine as PE  # noqa: E402

PAGE = 4
GAP = 1e-4
ARCHS = ("llama3-8b", "gemma3-4b", "rwkv6-3b", "jamba-1.5-large-398b",
         "deepseek-moe-16b")
STATE_ARCHS = ("gemma3-4b", "rwkv6-3b", "jamba-1.5-large-398b")
COUNTS = ("requests_completed", "tokens_out", "refills", "prefill_chunks",
          "prefix_hit_tokens", "prefix_lookup_tokens", "prefix_lookups",
          "state_lookups", "snapshot_hits", "snapshots_stored", "spills",
          "rehydrates", "spill_entries", "pages_total", "pages_peak",
          "cow_splits", "radix_nodes", "prefill_tokens", "decode_tokens",
          "prefix_mode")
_MODELS = {}


def _no_drop(cfg):
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))


def _model(arch, **kw):
    """(jcfg, pcfg, jparams, tparams): f32 smoke configs, MoE at E / k."""
    key = (arch, tuple(sorted(kw.items())))
    if key not in _MODELS:
        jcfg = _no_drop(dataclasses.replace(jget(arch), dtype="float32",
                                            **kw))
        pcfg = _no_drop(dataclasses.replace(pget(arch), dtype="float32",
                                            **kw))
        jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
        _MODELS[key] = (jcfg, pcfg, jparams,
                        bridge.to_torch(jax.device_get(jparams)))
    return _MODELS[key]


def _probed(engine):
    """Record every sampled step's top-2 logit gap (all rows)."""
    gaps, sample = [], engine._sample

    def probe(logits):
        top = torch.topk(logits.float(), 2, dim=-1).values
        gaps.extend((top[:, 0] - top[:, 1]).tolist())
        return sample(logits)
    engine._sample = probe
    return gaps


def _tokens(stats):
    return {k: r.tokens for k, r in stats.results.items()}


def _shared(make, cfg, n=6, seed=3):
    """The reference tests' system-prompt workload: a 12-token prefix,
    prompts of 14, 5 new tokens."""
    return make(cfg, n, prefix_len=12, prompt_len=14, gen_len=5, seed=seed)


KW = dict(num_slots=2, max_len=20, page_size=PAGE, num_pages=16)


def _both(arch, workload, mode="radix", model_kw=None, **kw):
    """The reference's and the port's stats on one workload (a function of
    (make_requests, cfg)); the port's top-2 gaps probed."""
    jcfg, pcfg, jparams, tparams = _model(arch, **(model_kw or {}))
    kw = {**KW, **kw}
    ref = JServeEngine(jcfg, jparams, prefix_mode=mode, **kw).run(
        workload(JE, jcfg))
    peng = ServeEngine(pcfg, tparams, prefix_mode=mode, **kw)
    gaps = _probed(peng)
    ours = peng.run(workload(PE, pcfg))
    assert gaps and min(gaps) > GAP, f"near-tie: top-2 gap {min(gaps)}"
    return ref, ours


def _port_run(arch, reqs, model_kw=None, **kw):
    _, pcfg, _, tparams = _model(arch, **(model_kw or {}))
    eng = ServeEngine(pcfg, tparams, **{**KW, **kw})
    gaps = _probed(eng)
    stats = eng.run(reqs)
    assert min(gaps) > GAP, f"near-tie: top-2 gap {min(gaps)}"
    return stats


def _check_counts(ours, ref):
    for field in COUNTS:
        assert getattr(ours, field) == getattr(ref, field), field
    assert _tokens(ours) == _tokens(ref)


# ---------------------------------------------------------------------------
# the engine against the reference's, in radix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_radix_engine_matches_reference(arch):
    """Shared-prefix workload, radix on both engines: equal tokens and
    counts; hits on every family, snapshot hits on the state families,
    fewer prefill chunks than the port's `off` run, whose tokens are the
    same."""
    shared = lambda E, cfg: _shared(E.make_shared_prefix_requests, cfg)
    ref, ours = _both(arch, shared)
    _check_counts(ours, ref)
    assert ours.prefix_mode == "radix" and ours.prefix_hit_tokens > 0
    if arch in STATE_ARCHS:
        assert ours.snapshot_hits > 0 and ours.snapshots_stored > 0
        assert ours.snapshot_hit_rate > 0
    _, pcfg, _, _ = _model(arch)
    off = _port_run(arch, _shared(make_shared_prefix_requests, pcfg),
                    prefix_mode="off")
    assert off.prefix_hit_tokens == 0 and off.prefix_mode == "off"
    assert ours.prefill_chunks < off.prefill_chunks
    assert _tokens(ours) == _tokens(off)


@pytest.mark.parametrize("arch", ("llama3-8b", "gemma3-4b", "rwkv6-3b"))
def test_branching_two_waves_match_reference(arch):
    """The zipf-branching workload twice on one engine: the first wave
    spills (the run's end flushes the tree), the second rehydrates; equal
    tokens and counts in both waves."""
    jcfg, pcfg, jparams, tparams = _model(arch)

    def wave(E, cfg):
        return E.make_branching_prefix_requests(
            cfg, 6, prompt_len=14, gen_len=4, page_size=PAGE,
            max_prefix_pages=2, seed=5)
    jeng = JServeEngine(jcfg, jparams, **KW)
    peng = ServeEngine(pcfg, tparams, **KW)
    gaps = _probed(peng)
    for i in range(2):
        ref, ours = jeng.run(wave(JE, jcfg)), peng.run(wave(PE, pcfg))
        _check_counts(ours, ref)
        assert (ours.spills if i == 0 else ours.rehydrates) > 0
    assert min(gaps) > GAP, f"near-tie: top-2 gap {min(gaps)}"


def test_gemma_wrapping_rings_match_reference_and_off():
    """gemma's window cut to 6, below the 14-token prompts: the rings wrap
    inside the second page, before the snapshots at 8 and 12. Radix equals
    the reference's radix, and its tokens the port's `off` tokens."""
    kw = {"sliding_window": 6}
    shared = lambda E, cfg: _shared(E.make_shared_prefix_requests, cfg)
    ref, ours = _both("gemma3-4b", shared, model_kw=kw)
    _check_counts(ours, ref)
    assert ours.snapshot_hits > 0
    _, pcfg, _, _ = _model("gemma3-4b", **kw)
    assert PD.init_serve_cache(pcfg, 1, 20, 1, PAGE, device="meta")[0][
        "blocks"]["sub0"]["k"].shape[2] == 6
    off = _port_run("gemma3-4b", _shared(make_shared_prefix_requests, pcfg),
                    model_kw=kw, prefix_mode="off")
    assert _tokens(ours) == _tokens(off)
    assert ours.prefill_chunks < off.prefill_chunks


def test_chain_engine_matches_reference():
    shared = lambda E, cfg: _shared(E.make_shared_prefix_requests, cfg)
    ref, ours = _both("llama3-8b", shared, mode="chain")
    _check_counts(ours, ref)
    assert ours.prefix_mode == "chain" and ours.prefix_hit_tokens > 0


def test_chunk_keys_sit_at_their_positions(monkeypatch):
    """`chunk_paged_attention` lays the keys out by position: the query at
    position 7 sees the same keys in the same slots whether it is row 7 of
    one 8-token chunk or row 0 of a chunk that resumes at 7 after a cached
    prefix (the exact-page-multiple match), so its softmax and PV sums add
    the same terms in the same order and its output is bitwise the same."""
    from repro_torch.models import layers as PL
    _, cfg, _, params = _model("llama3-8b")
    p = {k: v[0] for k, v in params["segments"]["blocks"]["attn"].items()}
    seen, scores = [], PL._grouped_scores

    def capture(q, k, v, mask):
        seen.append((k, mask))
        return scores(q, k, v, mask)
    monkeypatch.setattr(PL, "_grouped_scores", capture)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 8, cfg.d_model)).astype(np.float32))
    pt = torch.tensor([[2, 0, 3, 1]], dtype=torch.int32)     # L = 16
    zeros = lambda: {key: torch.zeros((4 * 4, cfg.num_kv_heads,
                                       cfg.resolved_head_dim))
                     for key in ("k", "v")}
    one = lambda start: torch.tensor([start], dtype=torch.int32)
    yes = torch.tensor([True])
    whole, _ = PL.chunk_paged_attention(p, cfg, x, one(0), yes, zeros(), pt,
                                        page_size=4)
    _, pool = PL.chunk_paged_attention(p, cfg, x, one(0), yes, zeros(), pt,
                                       page_size=4,
                                       length=torch.tensor([7]))
    tail = torch.cat([x[:, 7:], torch.zeros_like(x[:, 1:])], dim=1)
    resumed, _ = PL.chunk_paged_attention(p, cfg, tail, one(7), yes, pool,
                                          pt, page_size=4,
                                          length=torch.tensor([1]))
    (k_a, m_a), _, (k_b, m_b) = seen
    assert k_a.shape == k_b.shape == (1, 16 + 8) + tuple(k_a.shape[2:])
    assert torch.equal(m_a[0, 7], m_b[0, 0])
    assert m_a[0, 7].nonzero().flatten().tolist() == list(range(8))
    assert torch.equal(k_a[0, :8], k_b[0, :8])
    assert torch.equal(whole[0, 7], resumed[0, 0])


# ---------------------------------------------------------------------------
# the reference's engine-level prefix tests, on the port
# ---------------------------------------------------------------------------

def _oracle(cfg, params, toks, gen, max_len):
    """Contiguous batch=1 greedy tokens: prefill + decode_step, no serve or
    paging code."""
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


def test_prefix_sharing_hits_and_lowers_peak():
    """System-prompt workload on the fully-paged family: hits, copy-on-write
    splits of the shared partial page, a lower page peak and fewer prefill
    chunks than without sharing, and the same tokens."""
    _, cfg, _, _ = _model("llama3-8b")
    reqs = lambda: _shared(make_shared_prefix_requests, cfg, n=8)
    shared = _port_run("llama3-8b", reqs())
    plain = _port_run("llama3-8b", reqs(), prefix_sharing=False)
    assert shared.prefix_hit_rate > 0 and shared.cow_splits >= 1
    assert shared.pages_peak < plain.pages_peak
    assert shared.prefill_chunks < plain.prefill_chunks
    assert plain.prefix_hit_tokens == 0 and plain.prefix_mode == "off"
    assert shared.requests_completed == plain.requests_completed == 8
    assert _tokens(shared) == _tokens(plain)


def test_exact_page_multiple_prompts_share_last_page():
    """Identical prompts of exactly 2 pages: later admissions reuse the
    registrant's last full page as a ps-1 partial match, split it on their
    first decode write, and serve the tokens of the unshared run."""
    _, cfg, _, _ = _model("llama3-8b")
    toks = np.random.default_rng(23).integers(
        0, cfg.vocab_size, 2 * PAGE).astype(np.int32)
    reqs = lambda: [Request(i, 4, tokens=toks.copy()) for i in range(3)]
    kw = dict(max_len=2 * PAGE + 4, num_pages=None)
    shared = _port_run("llama3-8b", reqs(), **kw)
    plain = _port_run("llama3-8b", reqs(), prefix_sharing=False, **kw)
    assert shared.prefix_hit_tokens > PAGE
    assert shared.prefill_chunks < plain.prefill_chunks
    assert shared.cow_splits >= 1
    assert _tokens(shared) == _tokens(plain)


def test_tight_pool_shared_prefix_cannot_deadlock():
    """A pool exactly one request's worst case: a match would pin the pages
    the reservation counts on evicting, so the engine rolls it back and
    admits unshared, without inflating the prefix counters."""
    _, cfg, _, params = _model("llama3-8b")
    rng = np.random.default_rng(1)
    prefix = rng.integers(0, cfg.vocab_size, 6).astype(np.int32)
    tail = rng.integers(0, cfg.vocab_size, 2).astype(np.int32)
    a = Request(0, 3, tokens=prefix)
    b = Request(1, 4, tokens=np.concatenate([prefix, tail]))
    engine = ServeEngine(cfg, params, num_slots=1, max_len=12,
                         page_size=PAGE, num_pages=3)
    stats = engine.run([a, b])
    assert stats.requests_completed == 2
    assert stats.prefix_hit_tokens <= stats.prefix_lookup_tokens
    assert stats.results[1].tokens == _oracle(cfg, params, b.tokens, 4, 12)


@pytest.mark.parametrize("arch", ARCHS + ("musicgen-medium",))
def test_prefix_mode_resolution(arch):
    """radix serves every token family (the state ones through snapshots);
    embed-input archs resolve to off; chain only fully-paged configs;
    prefix_sharing=False is off."""
    cfg = pget(arch)
    params = {"x": torch.zeros(1)}        # the constructor reads a device
    assert PD.has_state_layers(cfg) == (arch in STATE_ARCHS)
    mode = lambda **kw: ServeEngine(cfg, params, num_slots=2, max_len=16,
                                    page_size=PAGE, **kw)
    embeds = cfg.embed_inputs
    eng = mode()
    assert eng.prefix_mode == ("off" if embeds else "radix")
    assert eng.prefix_sharing == (not embeds)
    paged_only = not embeds and arch not in STATE_ARCHS
    assert mode(prefix_mode="chain").prefix_mode == \
        ("chain" if paged_only else "off")
    assert mode(prefix_sharing=False).prefix_mode == "off"
    assert mode(prefix_mode="off")._spill is None


def test_cancel_while_snapshot_pinned_releases_cleanly():
    """rwkv: a request cancelled mid-stream still holds its pin on the
    snapshot node; cancellation releases it, the node stays reusable, and
    the identical requests around it serve the contiguous oracle's
    tokens."""
    _, cfg, _, params = _model("rwkv6-3b")
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, 14).astype(np.int32)
    engine = ServeEngine(cfg, params, num_slots=1, max_len=20,
                         page_size=PAGE)
    streamed = []

    def cb(rid, tok):
        streamed.append(tok)
        return len(streamed) < 2

    stats = engine.run([Request(0, 5, tokens=toks.copy()),
                        Request(1, 5, tokens=toks.copy(), stream=cb),
                        Request(2, 5, tokens=toks.copy())])
    assert stats.snapshot_hits >= 2
    assert stats.requests_cancelled == 1 and stats.requests_completed == 2
    want = _oracle(cfg, params, toks, 5, 20)
    assert stats.results[0].tokens == stats.results[2].tokens == want
    assert streamed == want[:2]
    assert all(n.pins == 0 for n in engine._cache._snaps.values())


def test_radix_strictly_beats_chain_attention_family():
    """Two waves of the zipf-branching workload: radix has strictly more
    hit tokens and strictly fewer prefill chunks than chain in the second
    wave (its spill tier outlives run()), and every wave serves the same
    tokens."""
    _, cfg, _, params = _model("llama3-8b")

    def two_waves(mode):
        engine = ServeEngine(cfg, params, prefix_mode=mode, **KW)
        return [engine.run(make_branching_prefix_requests(
            cfg, 6, prompt_len=14, gen_len=4, page_size=PAGE,
            max_prefix_pages=2, seed=5)) for _ in range(2)]

    (r1, r2), (c1, c2) = two_waves("radix"), two_waves("chain")
    assert r2.prefix_hit_tokens > c2.prefix_hit_tokens
    assert r2.prefill_chunks < c2.prefill_chunks
    assert r2.rehydrates > 0 and r1.spills > 0
    assert _tokens(r1) == _tokens(r2) == _tokens(c1) == _tokens(c2)


def test_radix_strictly_beats_chain_state_family():
    """rwkv: chain cannot snapshot recurrent state (it resolves to off),
    the radix tree can."""
    _, cfg, _, params = _model("rwkv6-3b")

    def run(mode):
        engine = ServeEngine(cfg, params, num_slots=2, max_len=20,
                             page_size=PAGE, prefix_mode=mode)
        assert engine.prefix_mode == ("off" if mode == "chain" else mode)
        return engine.run(make_shared_prefix_requests(
            cfg, 6, prefix_len=12, prompt_len=14, gen_len=4, seed=7))

    radix, chain = run("radix"), run("chain")
    assert radix.prefix_hit_tokens > chain.prefix_hit_tokens == 0
    assert radix.prefill_chunks < chain.prefill_chunks
    assert _tokens(radix) == _tokens(chain)


def _persist_reqs(cfg):
    return make_shared_prefix_requests(cfg, 3, prefix_len=8, prompt_len=10,
                                       gen_len=4, seed=9)


def _persist_engine(cfg, params, path, page=PAGE, **kw):
    return ServeEngine(cfg, params, num_slots=2, max_len=16, page_size=page,
                       num_pages=16, prefix_persist=str(path), **kw)


@pytest.mark.parametrize("arch", ("llama3-8b", "rwkv6-3b"))
def test_prefix_persist_survives_restart(tmp_path, arch):
    """A new engine on the same persist directory serves its first repeated
    prompt from the restored spill tier (rehydrates), with the tokens of
    an unshared engine; another page size cold-starts."""
    _, cfg, _, params = _model(arch)
    first = _persist_engine(cfg, params, tmp_path).run(_persist_reqs(cfg))
    assert first.spill_entries > 0
    assert (tmp_path / "prefix_tree.ckpt").exists()
    second = _persist_engine(cfg, params, tmp_path).run(_persist_reqs(cfg))
    assert second.rehydrates > 0 and second.prefix_hit_tokens > 0
    plain = ServeEngine(cfg, params, num_slots=2, max_len=16,
                        page_size=PAGE, num_pages=16,
                        prefix_sharing=False).run(_persist_reqs(cfg))
    assert _tokens(second) == _tokens(plain) == _tokens(first)
    third = _persist_engine(cfg, params, tmp_path, page=2 * PAGE)
    assert len(third._spill) == 0                # meta mismatch: cold
    assert third.run(_persist_reqs(cfg)).rehydrates == 0


def test_prefix_persist_meta_mismatch_and_torn_file_cold_start(tmp_path):
    """Another max_len or model name cold-starts silently; a torn file
    warns and cold-starts; none of them raises."""
    _, cfg, _, params = _model("llama3-8b")
    _persist_engine(cfg, params, tmp_path).run(_persist_reqs(cfg))
    assert len(_persist_engine(cfg, params, tmp_path)._spill) > 0
    other = ServeEngine(cfg, params, num_slots=2, max_len=18,
                        page_size=PAGE, prefix_persist=str(tmp_path))
    assert len(other._spill) == 0
    renamed = dataclasses.replace(cfg, name="other-model")
    assert len(_persist_engine(renamed, params, tmp_path)._spill) == 0
    path = tmp_path / "prefix_tree.ckpt"
    path.write_bytes(path.read_bytes()[:len(path.read_bytes()) // 2])
    with pytest.warns(UserWarning, match="corrupt"):
        torn = _persist_engine(cfg, params, tmp_path)
    assert len(torn._spill) == 0
    stats = torn.run(_persist_reqs(cfg))
    assert stats.rehydrates == 0 and stats.requests_completed == 3


def test_failed_run_still_persists(tmp_path):
    """A run that raises flushes the tree to disk on its way out."""
    _, cfg, _, params = _model("llama3-8b")
    eng = _persist_engine(cfg, params, tmp_path)
    reqs = _persist_reqs(cfg)

    def boom(rid, tok):
        if rid == 2:
            raise KeyboardInterrupt
    reqs[2].stream = boom
    with pytest.raises(KeyboardInterrupt):
        eng.run(reqs)
    assert (tmp_path / "prefix_tree.ckpt").exists()
    assert len(_persist_engine(cfg, params, tmp_path)._spill) > 0


# ---------------------------------------------------------------------------
# spill-tier files across the two frameworks
# ---------------------------------------------------------------------------

def _port_tier():
    tier = SpillTier(8)
    gen = torch.Generator().manual_seed(0)
    for i in range(4):
        pages = {"blocks": {"k": torch.randn((2, PAGE, 2, 3), generator=gen
                                             ).to(torch.bfloat16),
                            "v": torch.randn((2, PAGE, 2, 3), generator=gen)},
                 "tail": {}}
        snap = {"s": torch.randn((2, 1, 5), generator=gen)} if i % 2 else None
        tier.put(np.arange(PAGE * (i + 1), dtype=np.int32) + i,
                 pages=pages if i != 3 else None, snap=snap)
    tier.put(np.arange(PAGE, dtype=np.int32), snap={"s": torch.ones(2)})
    return tier


def _entries(tier):
    """[(token bytes, {path: (dtype, raw bytes)})] in LRU order."""
    def flat(tree, pre=""):
        if isinstance(tree, dict):
            return {k2: v2 for k, v in tree.items()
                    for k2, v2 in flat(v, f"{pre}/{k}").items()}
        a = bridge.to_numpy(tree) if isinstance(tree, torch.Tensor) \
            else np.asarray(tree)
        return {pre: (a.dtype.name, a.shape, a.tobytes())}
    return [(np.asarray(t, np.int32).tobytes(),
             flat({k: e[k] for k in ("pages", "snap") if k in e}))
            for t, e in tier.items()]


def test_port_spill_file_restores_in_the_reference(tmp_path):
    tier = _port_tier()
    path = str(tmp_path / "t.ckpt")
    PM.save_spill_tier(path, tier, meta={"page_size": PAGE})
    jtier = JP.SpillTier(8)
    meta = JM.restore_spill_tier(path, jtier)
    assert meta["page_size"] == PAGE and len(jtier) == len(tier) == 4
    assert _entries(jtier) == _entries(tier)


def test_reference_spill_file_restores_in_the_port(tmp_path):
    jtier = JP.SpillTier(8)
    for t, e in _port_tier().items():
        jtier.put(t, pages=bridge.to_numpy(e["pages"]) if "pages" in e
                  else None,
                  snap=bridge.to_numpy(e["snap"]) if "snap" in e else None)
    path = str(tmp_path / "t.ckpt")
    JM.save_spill_tier(path, jtier, meta={"model": "m"})
    tier = SpillTier(3)                     # capacity drops the oldest
    meta = PM.restore_spill_tier(path, tier)
    assert meta["model"] == "m" and tier.evicted == 1
    assert _entries(tier) == _entries(jtier)[1:]
    assert all(t.dtype == np.int32 for t, _ in tier.items())


# ---------------------------------------------------------------------------
# request generators and the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["shared", "branching"])
def test_request_generators_match_reference(kind):
    jcfg, pcfg = jget("llama3-8b"), pget("llama3-8b")
    if kind == "shared":
        make = lambda E, cfg: E.make_shared_prefix_requests(
            cfg, 7, prefix_len=20, prompt_len=37, gen_len=5, seed=4)
    else:
        make = lambda E, cfg: E.make_branching_prefix_requests(
            cfg, 9, prompt_len=40, gen_len=3, page_size=8,
            max_prefix_pages=3, branch=3, seed=6)
    want, got = make(JE, jcfg), make(PE, pcfg)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.rid, g.max_new_tokens) == (w.rid, w.max_new_tokens)
        assert g.tokens.dtype == np.int32 and \
            g.tokens.tobytes() == w.tokens.tobytes()


def _argv(*extra):
    return ["--arch", "llama3-8b", "--smoke", "--device", "cpu",
            "--requests", "6", "--batch", "2", "--prompt-len", "14",
            "--gen-len", "4", "--page-size", str(PAGE)] + list(extra)


@pytest.mark.parametrize("flags", [
    ["--shared-prefix-len", "12"],
    ["--shared-prefix-len", "12", "--prefix-mode", "chain"],
    ["--shared-prefix-len", "12", "--no-prefix-sharing"],
    ["--branching-prefix"],
], ids=["shared-radix", "shared-chain", "no-sharing", "branching"])
def test_cli_prefix_flags_serve(flags, capsys):
    """Each prefix flag serves, with the reference launcher's prompts and
    therefore its prefix and page counts (the params differ: each package
    draws its own from the seed, and counts do not depend on them)."""
    from repro.launch import serve as jlaunch
    stats = launch_serve.main(_argv(*flags))
    out = capsys.readouterr().out
    ap = jlaunch.add_serve_args(argparse.ArgumentParser())
    jargs = ap.parse_args([a for a in _argv(*flags)
                           if a not in ("--device", "cpu")])
    jcfg, jeng = jlaunch.build_engine(jargs)
    ref = jeng.run(jlaunch.build_requests(jargs, jcfg))
    for field in ("requests_completed", "tokens_out", "prefill_chunks",
                  "prefix_hit_tokens", "prefix_lookup_tokens", "pages_peak",
                  "cow_splits", "radix_nodes", "spills", "prefix_mode"):
        assert getattr(stats, field) == getattr(ref, field), field
    assert "[serve] 6/6 requests (0 cancelled), 24 tokens" in out
    assert f"prefix mode {stats.prefix_mode}, prefix hit rate " \
        f"{stats.prefix_hit_rate:.2f}" in out
    assert ("[serve] radix: " in out) == (stats.prefix_mode == "radix")
    if "--no-prefix-sharing" in flags:
        assert stats.prefix_mode == "off" and stats.prefix_hit_tokens == 0
    else:
        assert stats.prefix_hit_tokens > 0


def test_cli_prefix_persist_serves(tmp_path, capsys):
    argv = _argv("--shared-prefix-len", "12", "--prefix-persist",
                 str(tmp_path))
    first = launch_serve.main(argv)
    second = launch_serve.main(argv)
    out = capsys.readouterr().out
    assert first.rehydrates == 0 and second.rehydrates > 0
    assert _tokens(first) == _tokens(second)
    assert f"{second.spills} spills / {second.rehydrates} rehydrates" in out
