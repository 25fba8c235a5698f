"""The port's serving robustness against the reference's, on the llama3
smoke config (f32) from the reference's params: the fault schedule's
draws, the request journal's file format in both directions, and the
engine's fault sites, retries, quarantine, watchdog, load shedding and
crash replay, each with the reference's own assertions
(tests/test_chaos.py).

With `retry_backoff_s=0.0`, no watchdog and no deadlines the serve loop
depends on the fault draws alone, so the port and the reference, given the
same `FaultSchedule` and requests, make the same fired-fault sequence,
statuses, tokens and robustness counts (not `stragglers`, which reads
wall time), plain and with two personalized users.

Greedy tokens are compared exactly; every sampled step's top-2 logit gap
of the port's runs is probed and a gap under 1e-4 fails loudly, as in
tests/test_torch_serve.py."""
import warnings
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from repro_torch.testing import limit_threads  # noqa: E402

limit_threads()
jax = pytest.importorskip("jax")

from repro import configs as JCF  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.runtime import FaultSchedule as JFaultSchedule  # noqa: E402
from repro.runtime import InjectedFault as JInjectedFault  # noqa: E402
from repro.serve import PersonalizationConfig as JP13n  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import RequestJournal as JRequestJournal  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro.serve.engine import \
    make_shared_prefix_requests as jshared  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as PCF  # noqa: E402
from repro_torch.runtime import (FaultKind, FaultSchedule,  # noqa: E402
                                 InjectedCrash, InjectedFault)
from repro_torch.serve import (PersonalizationConfig, Request,  # noqa: E402
                               RequestJournal, ServeEngine,
                               make_shared_prefix_requests)

PROMPT_LEN = 16
GEN_LEN = 6
PAGE = 4
MAX_LEN = PROMPT_LEN + GEN_LEN
GAP = 1e-4
KW = dict(num_slots=2, max_len=MAX_LEN, page_size=PAGE)
COUNTS = ("faults_injected", "faults_by_kind", "retries", "sheds",
          "quarantined", "tokens_quarantined", "watchdog_kills",
          "stream_errors", "journal_replays", "requests_completed",
          "requests_cancelled", "tokens_out", "prefill_chunks",
          "prefix_hit_tokens", "cow_splits", "pages_peak", "train_waves",
          "delta_hits", "delta_lookups")


@pytest.fixture(scope="module")
def model():
    jcfg = JCF.get_smoke_config("llama3-8b")
    pcfg = PCF.get_smoke_config("llama3-8b")
    assert jcfg.dtype == pcfg.dtype == "float32"
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, pcfg, jparams, bridge.to_torch(jax.device_get(jparams))


def _reqs(cfg, n=5, seed=3):
    """The reference test's workload: a shared 2-page prefix, bitwise the
    same requests in both packages."""
    return make_shared_prefix_requests(cfg, n, 2 * PAGE, PROMPT_LEN,
                                       GEN_LEN, seed=seed)


def _jreqs(cfg, n=5, seed=3):
    return jshared(cfg, n, 2 * PAGE, PROMPT_LEN, GEN_LEN, seed=seed)


def _tokens(stats, status="completed"):
    return {r.rid: list(r.tokens) for r in stats.results.values()
            if r.status == status}


def _engine(model, **kw):
    _, cfg, _, params = model
    for k, v in KW.items():
        kw.setdefault(k, v)
    return ServeEngine(cfg, params, **kw)


def _probed(engine):
    """Record every sampled step's top-2 logit gap (all rows)."""
    gaps, sample = [], engine._sample

    def probe(logits):
        top = torch.topk(logits.float(), 2, dim=-1).values
        gaps.extend((top[:, 0] - top[:, 1]).tolist())
        return sample(logits)
    engine._sample = probe
    return gaps


def _no_tie(gaps):
    assert gaps and min(gaps) > GAP, f"near-tie: top-2 gap {min(gaps)}"


@pytest.fixture(scope="module")
def ref_tokens(model):
    """The reference engine's fault-free tokens for the 6-request workload
    (its first 5 requests are the 5-request one's)."""
    jcfg, _, jparams, _ = model
    stats = JServeEngine(jcfg, jparams, **KW).run(_jreqs(jcfg, 6))
    assert stats.faults_injected == 0 and stats.retries == 0
    return _tokens(stats)


# ---------------------------------------------------------------------------
# FaultSchedule: the reference's draws
# ---------------------------------------------------------------------------

SCHEDULES = {
    "rate": (0, dict(fault_rate=0.1)),
    "rates-poison": (12345, dict(rates={"alloc": 0.5, "torn": 0.3},
                                 poison_rids={3})),
    "max-faults": (7, dict(fault_rate=0.9, max_faults=5)),
    "kill-after": (2 ** 31 - 1, dict(fault_rate=0.3, kill_after=3,
                                     slow_s=0.01)),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_fault_schedule_draws_match_reference(name):
    """The same seed, rates, poison rids, max_faults and kill_after fire
    the same draws in both packages, over one fixed draw sequence; a draw
    is crc32(f"{seed}/{kind}/{n}") / 2^32 under the kind's rate."""
    seed, kw = SCHEDULES[name]
    ours, ref = FaultSchedule(seed, **kw), JFaultSchedule(seed, **kw)
    assert ours.rates == ref.rates and ours.slow_s == ref.slow_s
    rng = np.random.default_rng(seed % 1000)
    for _ in range(300):
        kind = FaultKind.ALL[int(rng.integers(0, len(FaultKind.ALL)))]
        site = int(rng.integers(-1, 6))
        site = None if site < 0 else site
        assert ours.draw(kind, site) == ref.draw(kind, site)
    for kind in FaultKind.ALL:
        for n in (0, 1, 17, 4096):
            want = (zlib.crc32(f"{seed}/{kind}/{n}".encode())
                    & 0xFFFFFFFF) / 2.0 ** 32
            assert ours._uniform(kind, n) == ref._uniform(kind, n) == want
    assert ours.sequence() == ref.sequence() and ours.sequence()
    assert ours.faults_injected == ref.faults_injected
    assert ours.faults_by_kind == ref.faults_by_kind
    assert [ours.crash_due(n) for n in range(6)] == \
        [ref.crash_due(n) for n in range(6)]


# ---------------------------------------------------------------------------
# the request journal
# ---------------------------------------------------------------------------

def test_journal_torn_tail_tolerated(tmp_path):
    """A crash mid-append leaves a torn final line; replay skips it
    (counted, warned) without losing the intact records before it."""
    jpath = str(tmp_path / "j.jsonl")
    j = RequestJournal(jpath)
    j.admit(Request(1, 4, tokens=np.arange(6, dtype=np.int32)))
    j.admit(Request(2, 4, tokens=np.arange(6, dtype=np.int32)))
    j.done(1, "completed")
    j.close()
    with open(jpath, "ab") as f:          # torn tail: half a record
        f.write(b'{"v": {"e": "done", "rid": 2')
    j2 = RequestJournal(jpath)
    with pytest.warns(UserWarning, match="torn"):
        pending = j2.pending_requests()
    assert [r.rid for r in pending] == [2]
    assert j2.torn_lines_skipped == 1
    assert pending[0].max_new_tokens == 4 and pending[0].user is None
    np.testing.assert_array_equal(pending[0].tokens, np.arange(6))
    assert isinstance(pending[0], Request)


def _write(J, R, path):
    j = J(path)
    rng = np.random.default_rng(0)
    for rid, user in ((3, None), (5, 1), (8, "alice"), (9, None)):
        j.admit(R(rid, 4 + rid, tokens=rng.integers(0, 256, 7 + rid)
                  .astype(np.int32), user=user))
    j.done(5, "completed")
    j.done(9, "quarantined")
    assert not j.admit(R(11, 2, embeds=np.zeros((3, 4), np.float32)))
    j.close()
    return path


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_journal_read_across_frameworks(writer, tmp_path):
    """Each package writes the other's file byte for byte, and replays the
    other's journal: the same pending requests, tokens, lengths and
    users."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # the embed request's warning
        ours = _write(RequestJournal, Request, str(tmp_path / "port.jsonl"))
        ref = _write(JRequestJournal, JRequest, str(tmp_path / "ref.jsonl"))
    assert open(ours, "rb").read() == open(ref, "rb").read()
    path = ref if writer == "reference" else ours
    Reader = RequestJournal if writer == "reference" else JRequestJournal
    got = Reader(path).pending_requests()
    want = (JRequestJournal if writer == "reference"
            else RequestJournal)(path).pending_requests()
    assert [r.rid for r in got] == [r.rid for r in want] == [3, 8]
    for a, b in zip(got, want):
        assert (a.max_new_tokens, a.user) == (b.max_new_tokens, b.user)
        assert a.tokens.dtype == b.tokens.dtype == np.int32
        np.testing.assert_array_equal(a.tokens, b.tokens)
    assert got[1].user == "alice"
    assert Reader(path).pending_rids() == {3, 8}


# ---------------------------------------------------------------------------
# graceful degradation in the engine (the reference's assertions)
# ---------------------------------------------------------------------------

def test_engine_token_parity_under_faults(model, ref_tokens):
    """10% transient faults across every injection point may delay
    requests but must not change a single served token; the fault-free
    engine reports every robustness counter at zero."""
    eng = _engine(model)
    gaps = _probed(eng)
    free = eng.run(_reqs(model[1]))
    ref = {k: ref_tokens[k] for k in range(5)}
    assert _tokens(free) == ref
    assert free.faults_injected == 0 and free.retries == 0
    assert free.quarantined == 0 and free.journal_replays == 0
    assert free.faults_by_kind == {} and free.stream_errors == 0

    chaos = FaultSchedule(0, fault_rate=0.10)
    eng = _engine(model, chaos=chaos, max_retries=10,
                  retry_backoff_s=0.0005)
    gaps += _probed(eng)
    stats = eng.run(_reqs(model[1]))
    assert stats.faults_injected > 0, "10% rate never fired: dead wiring"
    assert stats.retries > 0
    assert set(stats.faults_by_kind) == {"alloc", "step", "slow"}
    assert stats.requests_completed == len(ref)
    assert _tokens(stats) == ref, "injected faults changed served tokens"
    _no_tie(gaps)


def test_stream_fault_and_real_stream_exception_survive(model, ref_tokens):
    """A stream callback that raises, injected or broken, degrades that
    stream only: the request still completes with the same tokens, and the
    failures are counted."""
    calls = {"n": 0}

    def broken(rid, tok):
        calls["n"] += 1
        raise ValueError("client went away")

    reqs = _reqs(model[1], n=2)
    reqs[0].stream = broken
    stats = _engine(model, chaos=FaultSchedule(0, rates={"stream": 0.5})
                    ).run(reqs)
    assert stats.requests_completed == 2
    assert _tokens(stats) == {k: ref_tokens[k] for k in range(2)}
    assert calls["n"] > 0
    assert stats.stream_errors > 0
    assert stats.faults_injected > 0      # injected stream faults counted


def test_poison_request_quarantined_neighbors_unharmed(model, ref_tokens):
    """Every step draw fires for the poison rid: the retry budget
    quarantines it, and every other request completes with the fault-free
    tokens; nothing is dropped unaccounted."""
    poison = 1
    chaos = FaultSchedule(0, poison_rids={poison})
    stats = _engine(model, chaos=chaos, max_retries=2,
                    retry_backoff_s=0.0005).run(_reqs(model[1]))
    assert stats.quarantined == 1
    assert stats.retries == 3             # max_retries + the final straw
    assert stats.results[poison].status == "quarantined"
    assert stats.requests_completed == 4
    assert _tokens(stats) == {k: ref_tokens[k] for k in range(5)
                              if k != poison}
    assert len(stats.results) == 5
    assert stats.requests_completed + stats.requests_cancelled + \
        stats.quarantined == 5


def test_watchdog_quarantines_hung_request(model):
    """A request making no progress (poison, endless retry budget) trips
    the watchdog instead of spinning forever. The engine serves once
    fault-free first, then the watchdog is armed for the chaos run: at
    0.25 s, as the reference's test, or twice that warm run's wall time
    on a CPU loaded enough that a healthy slot's next step may come later
    than 0.25 s."""
    eng = _engine(model, max_retries=10 ** 6, retry_backoff_s=0.001,
                  retry_backoff_cap_s=0.002)
    warm = eng.run(_reqs(model[1], n=2, seed=9))
    reqs = _reqs(model[1], n=3)
    poison = reqs[0].rid
    eng.chaos = FaultSchedule(0, poison_rids={poison})
    eng.watchdog_s = max(0.25, 2 * warm.wall_s)
    stats = eng.run(reqs)
    assert stats.watchdog_kills >= 1
    assert stats.results[poison].status == "quarantined"
    assert stats.requests_completed == len(reqs) - 1


def test_load_shedding_below_watermark(model, ref_tokens):
    """With a high free-page watermark and a small pool, admission defers
    (sheds) while requests are in flight, and still finishes everything
    with the unshed tokens: shedding is backpressure, not loss."""
    need = -(-MAX_LEN // PAGE)            # pages per request, ceil
    kw = dict(num_slots=3, num_pages=3 * need, prefix_sharing=False)
    eng = _engine(model, shed_watermark=0.5, **kw)
    gaps = _probed(eng)
    stats = eng.run(_reqs(model[1], n=6))
    assert stats.sheds > 0, "watermark high enough that shedding must fire"
    assert stats.requests_completed == 6
    assert _tokens(stats) == ref_tokens
    assert _tokens(_engine(model, **kw).run(_reqs(model[1], n=6))) == \
        ref_tokens
    _no_tie(gaps)


def test_crash_journal_replay_with_prefix_hits(model, ref_tokens, tmp_path):
    """Kill the engine after 1 completion; the restarted engine replays
    every journaled in-flight request to completion with the fault-free
    tokens and prefix hits > 0 from the persisted spill tier; a third
    engine has nothing left to replay."""
    jpath = str(tmp_path / "journal.jsonl")
    ppath = str(tmp_path / "spill")
    eng = _engine(model, chaos=FaultSchedule(0, kill_after=1),
                  journal=jpath, prefix_persist=ppath)
    with pytest.raises(InjectedCrash):
        eng.run(_reqs(model[1]))
    eng._journal.close()

    eng2 = _engine(model, journal=jpath, prefix_persist=ppath)
    pending = eng2.recover_requests()
    assert pending, "in-flight requests were admitted before the crash"
    assert all(r.rid in ref_tokens for r in pending)
    stats = eng2.run(pending)
    assert stats.requests_completed == len(pending)
    assert stats.journal_replays == len(pending)
    assert stats.prefix_hit_tokens > 0, "restart should be warm, not cold"
    for rid, toks in _tokens(stats).items():
        assert toks == ref_tokens[rid]
    eng2._journal.close()
    eng3 = _engine(model, journal=jpath, prefix_persist=ppath)
    assert eng3.recover_requests() == []
    eng3._journal.close()


def test_a_real_step_error_is_not_retried(model):
    """Only injected faults are absorbed: an error the step itself raises
    (a failed launch, a kernel that did not build) propagates, under chaos
    and with an endless retry budget."""
    eng = _engine(model, chaos=FaultSchedule(0, fault_rate=0.1),
                  max_retries=10 ** 6, retry_backoff_s=0.0)
    step, calls = eng._step, []

    def failing(*args):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("CUDA error: unspecified launch failure")
        return step(*args)
    eng._step = failing
    with pytest.raises(RuntimeError, match="launch failure"):
        eng.run(_reqs(model[1]))
    assert len(calls) == 3


# ---------------------------------------------------------------------------
# the port's loop against the reference's, draw for draw
# ---------------------------------------------------------------------------

def _p13n(C, P):
    return P(sparse=C.SparseUpdateConfig(update_ratio=0.5,
                                         num_update_layers=2,
                                         channel_block=8),
             optimizer=C.OptimizerConfig(kind="sgd", learning_rate=0.05),
             train_tokens=8)


@pytest.mark.parametrize("personalized", [False, True],
                         ids=["plain", "personalized"])
def test_chaos_run_matches_reference(model, personalized, monkeypatch):
    """retry_backoff_s = 0, no watchdog, no deadlines: the same schedule
    and requests give the reference's fired-fault sequence, statuses,
    tokens and robustness counts, with a poison rid and a stream callback
    in the mix; personalized, 2 users whose waves follow the completion
    order under faults, the same wave losses within 1e-5."""
    jcfg, pcfg, jparams, tparams = model
    mk = lambda F: F(0, fault_rate=0.1, poison_rids={3})
    kw = dict(KW, max_retries=3, retry_backoff_s=0.0)
    jeng = JServeEngine(jcfg, jparams, chaos=mk(JFaultSchedule),
                        personalization=(_p13n(JCF, JP13n) if personalized
                                         else None), **kw)
    if personalized:
        # the reference's per-user selection (jax.random), carried over
        monkeypatch.setattr(
            ServeEngine, "_make_delta_entry",
            lambda self, user: bridge.delta_to_torch(
                jeng._make_delta_entry(user)))
    peng = ServeEngine(pcfg, tparams, chaos=mk(FaultSchedule),
                       personalization=(_p13n(PCF, PersonalizationConfig)
                                        if personalized else None), **kw)
    gaps = _probed(peng)
    runs = []
    for eng, reqs in ((jeng, _jreqs(jcfg, 6)), (peng, _reqs(pcfg, 6))):
        seen = []
        reqs[2].stream = lambda rid, tok, seen=seen: seen.append(tok)
        if personalized:
            for r in reqs:
                r.user = r.rid % 2
        runs.append((eng.run(reqs), seen))
    (ref, ref_seen), (ours, our_seen) = runs
    _no_tie(gaps)
    ours_seq = peng.chaos.sequence()
    assert ours_seq == jeng.chaos.sequence()
    assert {"alloc", "step", "slow", "stream"} <= set(ours.faults_by_kind)
    assert {k: (r.status, r.tokens) for k, r in ours.results.items()} == \
        {k: (r.status, r.tokens) for k, r in ref.results.items()}
    assert ours.results[3].status == "quarantined"
    for field in COUNTS:
        assert getattr(ours, field) == getattr(ref, field), field
    # an injected stream fault fires before the client's callback: the
    # client misses that token, the request does not
    missed = sum(1 for k, _, site in ours_seq if k == "stream")
    assert our_seen == ref_seen
    assert len(our_seen) == len(ours.results[2].tokens) - missed
    if personalized:
        assert ours.train_waves == ours.requests_completed >= 4
        for (u0, l0), (u1, l1) in zip(ours.wave_losses, ref.wave_losses):
            assert u0 == u1 and abs(l0 - l1) <= 1e-5


# ---------------------------------------------------------------------------
# a copy-on-write split, then an alloc fault in the same chunk
# ---------------------------------------------------------------------------

def _fires_at(F, draws):
    """A schedule of class F whose only fired draws are `draws`, a set of
    (kind, per-kind index)."""
    class At(F):
        def _uniform(self, kind, n):
            return 0.0 if (kind, n) in draws else 1.0
    return At(0, rates={"alloc": 0.5})


def test_copy_on_write_then_alloc_fault(model):
    """Request 2's prompt extends request 0's whole 6-token prompt, so it
    matches page 0 and request 0's partial page 1 and its first chunk
    [6, 10) copy-on-write splits page 1, then allocates page 2. The alloc
    fault fires between the two (alloc draw 8, after request 1 took
    pages in between, so the split page is not request 0's old copy). The
    port's split copies its rows in place, so the retried chunk finds them
    and the tokens are the fault-free ones. The reference assigns its
    functional copy only when the whole call returns: its page table keeps
    the uncopied page and request 2's tokens change (ROADMAP queue C)."""
    jcfg, pcfg, jparams, tparams = model
    rng = np.random.default_rng(1)
    a = rng.integers(0, 256, 6).astype(np.int32)
    c = rng.integers(0, 256, 9).astype(np.int32)
    b = np.concatenate([a, rng.integers(0, 256, 6).astype(np.int32)])
    specs = [(a, 2), (c, 4), (b, 3)]
    kw = dict(num_slots=1, max_len=16, page_size=PAGE, num_pages=12,
              retry_backoff_s=0.0)
    out = {}
    for side, E, F, Fault, R, cfg, p in (
            ("port", ServeEngine, FaultSchedule, InjectedFault, Request,
             pcfg, tparams),
            ("reference", JServeEngine, JFaultSchedule, JInjectedFault,
             JRequest, jcfg, jparams)):
        free = E(cfg, p, **kw).run(
            [R(i, g, tokens=t) for i, (t, g) in enumerate(specs)])
        chaos = _fires_at(F, {("alloc", 8)})
        eng = E(cfg, p, chaos=chaos, **kw)
        faulted, ensure = [], eng._ensure_writable

        def spy(slot, lo, hi, pools, eng=eng, ensure=ensure,
                Fault=Fault, faulted=faulted):
            splits = eng._pool.cow_splits
            try:
                return ensure(slot, lo, hi, pools)
            except Fault:
                faulted.append((slot.request.rid, lo, hi,
                                eng._pool.cow_splits - splits))
                raise
        eng._ensure_writable = spy
        stats = eng.run([R(i, g, tokens=t) for i, (t, g) in
                         enumerate(specs)])
        assert chaos.sequence() == [("alloc", 8, None)]
        # the fault came in request 2's first chunk, after one split
        assert faulted == [(2, 6, 10, 1)]
        assert stats.prefix_hit_tokens == 6 and stats.retries == 1
        assert stats.requests_completed == 3
        out[side] = (_tokens(free), _tokens(stats))
    free, faulted = out["port"]
    assert faulted == free == out["reference"][0]
    ref_free, ref_faulted = out["reference"]
    assert ref_faulted[2] != ref_free[2]
    assert {k: ref_faulted[k] for k in (0, 1)} == \
        {k: ref_free[k] for k in (0, 1)}


# ---------------------------------------------------------------------------
# a state family: faults fire before any step
# ---------------------------------------------------------------------------

def test_rwkv_faults_fire_before_any_step():
    """rwkv6's smoke config (state only, no pages): under 10% faults the
    tokens are the fault-free run's, and the step runs exactly once per
    prefill chunk and decode step counted, so no faulted attempt launched
    anything (on the card: 32 wkv6 launches each)."""
    cfg = PCF.get_smoke_config("rwkv6-3b")
    from repro_torch.models import transformer as T
    params = T.init_params(cfg, 0, "cpu")
    kw = dict(num_slots=2, max_len=MAX_LEN, page_size=PAGE,
              prefix_mode="off")
    free = ServeEngine(cfg, params, **kw).run(_reqs(cfg))
    eng = ServeEngine(cfg, params, chaos=FaultSchedule(0, fault_rate=0.1),
                      max_retries=10, retry_backoff_s=0.0, **kw)
    step, calls = eng._step, []
    eng._step = lambda *a: (calls.append(1), step(*a))[1]
    stats = eng.run(_reqs(cfg))
    assert stats.faults_injected > 0 and stats.pages_total == 0
    assert "alloc" not in stats.faults_by_kind      # no pages, no allocs
    assert _tokens(stats) == _tokens(free)
    assert len(calls) == stats.prefill_chunks + len(stats.decode_step_s)
    assert len(stats.decode_step_s) > len(free.decode_step_s)
