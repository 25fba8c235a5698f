"""The port's serve engine against the reference's `ServeEngine(prefix_mode=
"off")` on the llama3 smoke config (f32), from the reference's params:
identical greedy tokens for plain serving across page boundaries, slot
refill, cancellation and timeouts, and for personalized serving with online
train waves (the reference's per-user selection injected); the same
`ServeStats` counts. Plus the engine against the port's own contiguous
oracle, the personalized engine against a dense-scatter oracle, the page
pool and scheduler copies, sampling, and the CLI.

Greedy tokens are compared exactly. That is sound only where no step's top
two logits nearly tie, so every sampled step's top-2 gap is probed: a gap
under 1e-4 fails loudly (f32 logits of the two frameworks differ by ~1e-6,
sums in another order). Wave losses hold to 1e-5 and deltas to 1e-6, as in
tests/test_torch_delta.py."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import configs as JCF  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve import PagePool as JPagePool  # noqa: E402
from repro.serve import PersonalizationConfig as JP13n  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import Scheduler as JScheduler  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as PCF  # noqa: E402
from repro_torch.core.delta import apply_delta_tree  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import decoding as PD  # noqa: E402
from repro_torch.serve import (PagePool, PersonalizationConfig, Request,  # noqa: E402
                               Scheduler, ServeEngine, sample_token)
from repro_torch.train.steps import merge_params  # noqa: E402

PAGE = 4
GAP = 1e-4


def _p13n(C, P, lr=0.05):
    return P(sparse=C.SparseUpdateConfig(update_ratio=0.5,
                                         num_update_layers=2,
                                         channel_block=8),
             optimizer=C.OptimizerConfig(kind="sgd", learning_rate=lr),
             train_tokens=8)


@pytest.fixture(scope="module")
def model():
    jcfg = JCF.get_smoke_config("llama3-8b")
    pcfg = PCF.get_smoke_config("llama3-8b")
    assert jcfg.dtype == pcfg.dtype == "float32"
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, pcfg, jparams, bridge.to_torch(jax.device_get(jparams))


def _probed(engine):
    """Record every sampled step's top-2 logit gap (all rows)."""
    gaps, sample = [], engine._sample

    def probe(logits):
        top = torch.topk(logits.float(), 2, dim=-1).values
        gaps.extend((top[:, 0] - top[:, 1]).tolist())
        return sample(logits)
    engine._sample = probe
    return gaps


def _requests(R, specs, vocab, seed, per_rid):
    rng = np.random.default_rng(seed)
    return [R(rid, gen, tokens=rng.integers(0, vocab, plen).astype(np.int32),
              **per_rid.get(rid, {}))
            for rid, (plen, gen) in enumerate(specs)]


def _check_stats(ours, ref):
    for field in ("requests_completed", "requests_cancelled", "tokens_out",
                  "tokens_cancelled", "refills", "prefill_chunks",
                  "pages_total", "pages_peak", "cow_splits",
                  "prefill_tokens", "decode_tokens", "delta_hits",
                  "delta_lookups", "delta_evictions",
                  "delta_resident_bytes", "train_waves"):
        assert getattr(ours, field) == getattr(ref, field), field
    assert ours.prefix_mode == ref.prefix_mode == "off"
    assert {k: (r.tokens, r.status) for k, r in ours.results.items()} == \
        {k: (r.tokens, r.status) for k, r in ref.results.items()}


def _run_both(model, specs, num_slots, max_len, seed=11, req_kw=None,
              p13n=False, monkeypatch=None):
    jcfg, pcfg, jparams, tparams = model
    kw = dict(num_slots=num_slots, max_len=max_len, page_size=PAGE)
    jeng = JServeEngine(jcfg, jparams, prefix_mode="off",
                        personalization=_p13n(JCF, JP13n) if p13n else None,
                        **kw)
    if p13n:
        # the reference's per-user selection (jax.random), carried over
        monkeypatch.setattr(
            ServeEngine, "_make_delta_entry",
            lambda self, user: bridge.delta_to_torch(
                jeng._make_delta_entry(user)))
    peng = ServeEngine(pcfg, tparams,
                       personalization=(_p13n(PCF, PersonalizationConfig)
                                        if p13n else None), **kw)
    gaps = _probed(peng)
    req_kw = req_kw or {}
    ref = jeng.run(_requests(JRequest, specs, jcfg.vocab_size, seed,
                             req_kw.get("ref", {})))
    ours = peng.run(_requests(Request, specs, pcfg.vocab_size, seed,
                              req_kw.get("port", {})))
    assert gaps and min(gaps) > GAP, f"near-tie: top-2 gap {min(gaps)}"
    _check_stats(ours, ref)
    return jeng, peng, ref, ours


def test_engine_matches_reference_across_pages_and_refills(model):
    """Prompts of PAGE-1, PAGE, PAGE+1 and longer tokens over 2 slots: the
    partial-chunk, exact-page and page-straddling admissions, and three
    refills of a used slot."""
    specs = [(PAGE - 1, 6), (PAGE, 2), (PAGE + 1, 6), (3 * PAGE, 4),
             (2 * PAGE + 1, 5)]
    _, _, _, ours = _run_both(model, specs, 2, 3 * PAGE + 6)
    assert ours.requests_completed == 5 and ours.refills == 3


def test_engine_matches_reference_with_cancellation_and_timeout(model):
    """A stream that stops after 2 tokens and a request whose deadline has
    passed while it was queued: the same tokens and counters as the
    reference's, cancelled work counted apart."""
    specs = [(6, 6), (5, 6), (7, 4)]

    def stop_after(n):
        seen = []
        return lambda rid, tok: (seen.append(tok), len(seen) < n)[1]

    req_kw = {side: {1: {"stream": stop_after(2)}, 2: {"timeout_s": 0.0}}
              for side in ("ref", "port")}
    _, _, _, ours = _run_both(model, specs, 1, 14, req_kw=req_kw)
    assert ours.results[1].status == "cancelled"
    assert len(ours.results[1].tokens) == 2
    assert ours.results[2].status == "cancelled"
    assert ours.results[2].tokens == []
    assert ours.requests_completed == 1 and ours.tokens_cancelled == 2


def test_personalized_engine_matches_reference(model, monkeypatch):
    """Two users over 2 slots, 5 requests: each completion runs a wave, a
    live slot of the same user picks the new delta up mid-stream. Tokens,
    counters, wave losses and every user's final delta against the
    reference's, from its per-user selection; the base params untouched."""
    _, _, _, tparams = model
    before = [a.copy() for a in jax.tree.leaves(bridge.to_numpy(tparams))]
    specs = [(6, 7), (5, 3), (9, 4), (4, 6), (7, 5)]
    users = {r: {"user": r % 2} for r in range(5)}
    jeng, peng, ref, ours = _run_both(
        model, specs, 2, 9 + 7, req_kw={"ref": users, "port": users},
        p13n=True, monkeypatch=monkeypatch)
    assert ours.train_waves == 5
    for (u0, l0), (u1, l1) in zip(ours.wave_losses, ref.wave_losses):
        assert u0 == u1 and abs(l0 - l1) <= 1e-5
    for user in (0, 1):
        got = bridge.delta_to_numpy(peng._deltas.peek(user))
        want = jeng._deltas.peek(user)
        for a, b in zip(jax.tree.leaves(got["idx"]), jax.tree.leaves(
                want.idx)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(jax.tree.leaves(got["vals"]), jax.tree.leaves(
                want.vals)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
            assert np.abs(a).max() > 0
    after = jax.tree.leaves(bridge.to_numpy(tparams))
    assert all(np.array_equal(a, b) for a, b in zip(before, after))


# ---------------------------------------------------------------------------
# the port against its own oracles
# ---------------------------------------------------------------------------

def _oracle(cfg, params, toks, gen, max_len):
    """Contiguous batch=1 greedy ground truth: prefill + decode_step, no
    serve or paging code."""
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


def test_engine_matches_contiguous_oracle(model):
    _, cfg, _, params = model
    max_len = 3 * PAGE + 6
    engine = ServeEngine(cfg, params, num_slots=2, max_len=max_len,
                         page_size=PAGE)
    gaps = _probed(engine)
    rng = np.random.default_rng(13)
    for plen in (PAGE - 1, PAGE, PAGE + 1, 3 * PAGE):
        toks = rng.integers(0, cfg.vocab_size, plen).astype(np.int32)
        served = engine.run([Request(0, 6, tokens=toks)]).results[0].tokens
        assert served == _oracle(cfg, params, toks, 6, max_len), plen
    assert min(gaps) > GAP, f"near-tie: top-2 gap {min(gaps)}"


def test_personalized_engine_matches_dense_scatter_oracle(model):
    """Zero-delta personalized serving == the base model; after a wave, a
    personalized request == the oracle on params with the user's delta
    dense-scattered into a copy (the weights serving never builds)."""
    _, cfg, _, params = model
    max_len = 12 + 6
    engine = ServeEngine(cfg, params, num_slots=1, max_len=max_len,
                         page_size=PAGE,
                         personalization=_p13n(PCF, PersonalizationConfig))
    gaps = _probed(engine)
    rng = np.random.default_rng(7)
    t1, t2 = (rng.integers(0, cfg.vocab_size, 12).astype(np.int32)
              for _ in range(2))
    r1 = engine.run([Request(0, 6, tokens=t1, user=9)]).results[0]
    assert r1.tokens == _oracle(cfg, params, t1, 6, max_len)
    entry = engine._deltas.peek(9)
    trainable = dict(engine._trainable)
    trainable["segments"] = apply_delta_tree(
        engine._trainable["segments"], entry.vals, entry.idx,
        engine._plan.spec)
    pers = merge_params(engine._frozen, trainable)
    r2 = engine.run([Request(1, 6, tokens=t2, user=9)]).results[1]
    assert r2.tokens == _oracle(cfg, pers, t2, 6, max_len)
    assert min(gaps) > GAP, f"near-tie: top-2 gap {min(gaps)}"


def test_user_selection_stable_across_eviction(model):
    _, cfg, _, params = model
    engine = ServeEngine(cfg, params, num_slots=1, max_len=16,
                         page_size=PAGE,
                         personalization=_p13n(PCF, PersonalizationConfig))
    e1, e2, e3 = (engine._make_delta_entry(u) for u in (42, 42, 43))
    flat = lambda e: jax.tree.leaves(bridge.to_numpy(e.idx))
    assert all(np.array_equal(a, b) for a, b in zip(flat(e1), flat(e2)))
    assert any(not np.array_equal(a, b) for a, b in zip(flat(e1), flat(e3)))
    for a in flat(e1):        # distinct blocks within each (layer, shard)
        assert all(len(set(row)) == len(row)
                   for row in a.reshape(-1, a.shape[-1]).tolist())


# ---------------------------------------------------------------------------
# host-side copies: page pool and scheduler
# ---------------------------------------------------------------------------

def _pool_op(pool, op, pid):
    try:
        if op == 0:
            return pool.alloc()
        if op == 1:
            return pool.decref(pid)
        if op == 2:
            return pool.incref(pid) if pool.ref[pid] > 0 else None
        return pool.cow_split(pid) if pool.ref[pid] >= 2 else None
    except RuntimeError as e:
        return type(e)


@pytest.mark.parametrize("seed", range(4))
def test_page_pool_matches_reference_on_random_ops(seed):
    rng = np.random.default_rng(seed)
    ours, ref = PagePool(6, PAGE), JPagePool(6, PAGE)
    for _ in range(150):
        op, pid = int(rng.integers(0, 4)), int(rng.integers(0, 6))
        assert _pool_op(ours, op, pid) == _pool_op(ref, op, pid)
        ours.check()
        assert ours.ref.tolist() == ref.ref.tolist()
        assert (ours.free_pages, ours.peak_in_use, ours.cow_splits) == \
            (ref.free_pages, ref.peak_in_use, ref.cow_splits)
    with pytest.raises(NotImplementedError, match="item 13"):
        PagePool(2, PAGE, chaos=object())


def test_scheduler_matches_reference():
    """The same admissions, tokens and cancellations through both
    schedulers: the same slot states and counters."""
    ours, ref = Scheduler(2, eos_id=5), JScheduler(2, eos_id=5)
    for S, R in ((ours, Request), (ref, JRequest)):
        for rid in range(4):
            S.submit(R(rid, 3, tokens=np.zeros(2, np.int32)))
    toks = iter([1, 5, 2, 2, 2, 7, 7, 7, 3, 3])
    for step in range(6):
        tok = next(toks)
        for S in (ours, ref):
            while (adm := S.peek_admission()) is not None:
                S.commit_admission(adm[0])
            for slot in S.prefill_slots():
                slot.pos = slot.request.prompt_len
                S.finish_prefill(slot)
            for slot in S.active_slots():
                if step == 3 and slot.index == 1:
                    S.cancel(slot)
                else:
                    S.record_token(slot, tok)
        assert [(s.state.value, s.generated) for s in ours.slots] == \
            [(s.state.value, s.generated) for s in ref.slots]
    for field in ("requests_completed", "requests_cancelled", "tokens_out",
                  "tokens_cancelled", "refills", "done"):
        assert getattr(ours, field) == getattr(ref, field), field


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def test_greedy_sampling_is_first_argmax():
    logits = torch.tensor([[0.0, 2.0, 2.0, 1.0], [3.0, -1.0, 3.0, 3.0]])
    assert sample_token(logits).tolist() == [1, 0]
    assert sample_token(logits).dtype == torch.int32


def test_temperature_sampling_is_deterministic_per_seed(model):
    """The port cannot replay jax.random: its draws are held to their
    properties. One seed, one token sequence; another seed, another."""
    _, cfg, _, params = model

    def run(seed):
        engine = ServeEngine(cfg, params, num_slots=2, max_len=16,
                             page_size=PAGE, temperature=1.0, seed=seed)
        reqs = [Request(i, 8, tokens=np.arange(4, dtype=np.int32) + i)
                for i in range(3)]
        return [r.tokens for r in engine.run(reqs).results.values()]
    assert run(0) == run(0)
    assert run(0) != run(1)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _argv(*extra):
    return ["--arch", "llama3-8b", "--smoke", "--device", "cpu",
            "--prompt-len", "6", "--gen-len", "4", "--page-size",
            str(PAGE)] + list(extra)


def test_cli_exact_counts(capsys):
    stats = launch_serve.main(_argv("--requests", "7", "--batch", "4"))
    assert stats.requests_completed == 7 and stats.tokens_out == 28
    assert stats.refills == 3 and stats.prefill_chunks == 14
    out = capsys.readouterr().out
    assert "[serve] 7/7 requests (0 cancelled), 28 tokens" in out
    stats = launch_serve.main(_argv("--requests", "6", "--batch", "2",
                                    "--users", "2"))
    assert stats.requests_completed == 6 and stats.train_waves == 6
    assert stats.delta_lookups == 6 and stats.delta_hits == 4
    assert "personalization: 2 users, 6 train waves" in \
        capsys.readouterr().out


@pytest.mark.parametrize("flag", [
    ["--prefix-mode", "radix"], ["--prefix-mode", "chain"],
    ["--branching-prefix"], ["--shared-prefix-len", "4"],
    ["--prefix-persist", "x"], ["--fault-rate", "0.1"],
    ["--kill-after", "1"], ["--journal", "x"], ["--watchdog-s", "1"],
    ["--shed-watermark", "0.1"], ["--mesh-model", "2"], ["--flash-decode"],
], ids=lambda f: f[0].lstrip("-") + (f"={f[1]}" if len(f) > 1 else ""))
def test_cli_refuses_unported_flags(flag):
    with pytest.raises(NotImplementedError, match="ROADMAP queue A item"):
        launch_serve.main(_argv("--requests", "1", *flag))


def test_cli_defaults_to_the_card():
    args = launch_serve.add_serve_args(
        __import__("argparse").ArgumentParser()).parse_args(
            ["--arch", "llama3-8b"])
    assert args.device == "cuda" and args.prefix_mode == "off"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch_serve.build_engine(args)


def test_engine_refuses_unported_options(model):
    _, cfg, _, params = model
    for kw in ({"prefix_mode": "radix"}, {"chaos": object()},
               {"journal": "j"}, {"watchdog_s": 1.0},
               {"shed_watermark": 0.1}, {"prefix_persist": "p"},
               {"rules": object()}, {"flash_decode": True}):
        with pytest.raises(NotImplementedError, match="ROADMAP queue A"):
            ServeEngine(cfg, params, num_slots=1, max_len=8, **kw)
    assert dataclasses.is_dataclass(ServeEngine(
        cfg, params, num_slots=1, max_len=8).run([]))
