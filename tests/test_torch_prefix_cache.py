"""The port's prefix caches (`repro_torch.serve.paging`: `RadixPrefixCache`,
`ChainPrefixCache`, `SpillTier`) against the reference's, and its page-row
spill helpers (`models.decoding.read_pool_rows` / `write_pool_rows`)
against the reference's on bridged pools.

The random-operation tests drive the port's cache and the reference's with
the same submit / match / snapshot / evict / release / spill / rehydrate
calls from fixed numpy seeds, and after every operation hold them equal:
each `MatchResult`'s pages, coverage and snapshot, every counter, the node
count, the pools' refcounts and free lists and the spill tier's entries in
LRU order. The port's page-content model is updated through the writer the
cache calls in `_rehydrate`, so a rehydrated page is checked against the
rows it really holds. Page rows and snapshots on the port's side are torch
tensors (bf16 too), on the reference's side numpy arrays. The rest are the
reference's deterministic cache tests (`tests/test_paging.py`), run
against the port."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from repro_torch.testing import limit_threads  # noqa: E402

limit_threads()
jax = pytest.importorskip("jax")

from repro.configs import get_smoke_config as jget  # noqa: E402
from repro.models import decoding as JD  # noqa: E402
from repro.serve import paging as JP  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_smoke_config as pget  # noqa: E402
from repro_torch.core.sparse_update import tree_leaves, tree_map  # noqa: E402
from repro_torch.models import decoding as PD  # noqa: E402
from repro_torch.serve import paging as PP  # noqa: E402
from repro_torch.serve.paging import (ChainPrefixCache, PagePool,  # noqa: E402
                                      RadixPrefixCache, SpillTier)

PS = 4
COUNTERS = ("hit_tokens", "lookup_tokens", "lookups", "state_lookups",
            "snapshot_hits", "snapshots_stored", "snapshot_bytes", "spills",
            "rehydrates", "node_count")


# ---------------------------------------------------------------------------
# fake device pools: one host array of token rows per side
# ---------------------------------------------------------------------------

class _PortDevice:
    """The port's stand-in for the engine's layer pools: torch rows
    [num_pages * PS, 3] whose values are the tokens they were filled from.
    `content` maps a page to the token bytes it holds; the writer (the
    cache's rehydrate callback) updates it from the rows it writes."""

    def __init__(self, num_pages, dtype=torch.float32):
        self.rows = torch.zeros((num_pages * PS, 3), dtype=dtype)
        self.content = {}

    def reader(self, pid):
        return {"rows": self.rows[pid * PS:(pid + 1) * PS].clone()}

    def writer(self, pid, blob):
        self.rows[pid * PS:(pid + 1) * PS] = blob["rows"]
        self.content[pid] = blob["rows"][:, 0].to(
            torch.int32).numpy().tobytes()

    def fill(self, pid, toks):
        page = np.resize(np.asarray(toks, np.int32), PS)
        self.rows[pid * PS:(pid + 1) * PS] = torch.from_numpy(
            page.astype(np.float32))[:, None]
        self.content[pid] = page.tobytes()


class _RefDevice:
    def __init__(self, num_pages):
        self.rows = np.zeros((num_pages * PS, 3), np.float32)

    def reader(self, pid):
        return {"rows": self.rows[pid * PS:(pid + 1) * PS].copy()}

    def writer(self, pid, blob):
        self.rows[pid * PS:(pid + 1) * PS] = blob["rows"]

    def fill(self, pid, toks):
        self.rows[pid * PS:(pid + 1) * PS] = np.resize(
            np.asarray(toks, np.float32), PS)[:, None]


def _radix(num_pages=64, spill=None, dtype=torch.float32, **kw):
    pool = PagePool(num_pages, PS)
    dev = _PortDevice(num_pages, dtype)
    cache = RadixPrefixCache(pool, has_pages=True, reader=dev.reader,
                             writer=dev.writer, spill=spill, **kw)
    return pool, dev, cache


def _ref_radix(num_pages=64, spill=None, **kw):
    pool = JP.PagePool(num_pages, PS)
    dev = _RefDevice(num_pages)
    cache = JP.RadixPrefixCache(pool, has_pages=True, reader=dev.reader,
                                writer=dev.writer, spill=spill, **kw)
    return pool, dev, cache


def _check_content(dev, mr, toks):
    """Every matched page holds the tokens it claims (the page-content
    model, with rehydrated pages included)."""
    off = 0
    for pid, fill in mr.pages:
        assert dev.content[pid][:fill * 4] == \
            np.ascontiguousarray(toks[off:off + fill]).tobytes()
        off += fill


def _submit(pool, dev, cache, toks, check=False):
    """One request through the engine's cache protocol: match, split the
    partial continuation, 'prefill' the uncovered pages, insert, finish.
    Returns (the match, the pages the request held)."""
    plen = len(toks)
    mr = cache.match(toks, plen - 1)
    assert mr.covered <= plen - 1
    if check:
        _check_content(dev, mr, toks)
    held = [pid for pid, _ in mr.pages]
    n_full = sum(1 for _, f in mr.pages if f == PS)
    if mr.pages and mr.pages[-1][1] < PS:
        if pool.free_pages:         # an append splits the shared page
            new = pool.cow_split(mr.pages[-1][0])
            dev.fill(new, toks[(len(held) - 1) * PS:])
            held[-1] = new
        else:
            pool.decref(held.pop())
    n_pages = -(-plen // PS)
    while len(held) < n_pages and pool.free_pages:
        pid = pool.alloc()
        dev.fill(pid, toks[len(held) * PS:])
        held.append(pid)
    if len(held) == n_pages:
        assert cache.insert_pages(toks, plen // PS, held, n_full) == \
            plen // PS
        if plen % PS:
            cache.insert_partial(toks, held[-1])
    cache.release(mr)
    for pid in held:                # the request finishes
        pool.decref(pid)
    return mr, held


def _same_blob(got, want):
    """A port blob (torch) equals a reference blob (numpy), bitwise."""
    if want is None or got is None:
        return got is None and want is None
    assert sorted(got) == sorted(want)
    return all(np.array_equal(bridge.to_numpy(got[k]), want[k]) for k in want)


def _same_match(got, want):
    assert got.pages == want.pages and got.covered == want.covered
    assert (got.node is None) == (want.node is None)
    assert _same_blob(got.snapshot, want.snapshot)


def _same_state(port, ref):
    (pool, dev, cache, tier), (jpool, jdev, jcache, jtier) = port, ref
    for name in COUNTERS:
        assert getattr(cache, name) == getattr(jcache, name), name
    assert pool.ref.tolist() == jpool.ref.tolist()
    assert pool._free == jpool._free
    assert (pool.peak_in_use, pool.cow_splits) == \
        (jpool.peak_in_use, jpool.cow_splits)
    assert [t.tobytes() for t, _ in tier.items()] == \
        [t.tobytes() for t, _ in jtier.items()]
    assert (tier.puts, tier.takes, tier.evicted) == \
        (jtier.puts, jtier.takes, jtier.evicted)
    for (_, e), (_, je) in zip(tier.items(), jtier.items()):
        assert _same_blob(e.get("pages"), je.get("pages"))
        assert _same_blob(e.get("snap"), je.get("snap"))
    pool.check()
    cache.check()
    jcache.check()
    # device rows agree wherever a page is in use
    for pid in range(pool.num_pages):
        if pool.ref[pid] > 0:
            np.testing.assert_array_equal(
                dev.rows[pid * PS:(pid + 1) * PS].numpy(),
                jdev.rows[pid * PS:(pid + 1) * PS])


def _snap(value, port):
    a = np.full(3, value, np.float32)
    return {"s": torch.from_numpy(a) if port else a}


@pytest.mark.parametrize("seed", range(12))
def test_radix_equals_reference_under_random_ops(seed):
    """Random interleavings of submit, pinned match (with and without
    need_state), snapshot insertion, eviction, slot close and spill_all on
    prompts built from a bank of 3 pages, a 16-page pool, a 24-entry spill
    tier, a snapshot budget of 3 and at most 10 tree nodes: after every operation the two caches agree, every
    matched page holds its tokens, and a full drain frees every page."""
    rng = np.random.default_rng(seed)
    sides = []
    for port in (True, False):
        tier = (SpillTier if port else JP.SpillTier)(24)
        mk = _radix if port else _ref_radix
        pool, dev, cache = mk(num_pages=16, spill=tier, snapshot_budget=3,
                              max_nodes=10)
        sides.append((pool, dev, cache, tier))
    port, ref = sides
    pinned = []                     # live matches (open slots), per side
    # prompts: 0-3 pages from a bank of 3, then 0-3 free tokens, so that
    # prompts share prefixes often and diverge at every depth
    bank = rng.integers(0, 3, (3, PS)).astype(np.int32)
    for _ in range(80):
        op = int(rng.integers(0, 8))
        pages = [bank[i] for i in rng.integers(0, 3, int(rng.integers(0, 4)))]
        toks = np.concatenate(pages + [rng.integers(
            0, 3, int(rng.integers(0, PS))).astype(np.int32)])
        if len(toks) < 2:
            toks = np.concatenate([bank[0], toks])
        plen = len(toks)
        if op in (0, 7) and port[0].free_pages >= -(-plen // PS) + 1:
            out = [_submit(*s[:3], toks, check=s is port) for s in sides]
            _same_match(out[0][0], out[1][0])
            assert out[0][1] == out[1][1]
        elif op == 1:
            assert port[2].evict_one() == ref[2].evict_one()
        elif op in (2, 3):          # match and HOLD the pin
            need = op == 3
            mrs = [s[2].match(toks, plen - 1, need_state=need)
                   for s in sides]
            _same_match(*mrs)
            if not need:
                _check_content(port[1], mrs[0], toks)
            pinned.append(mrs)
        elif op == 4 and pinned:    # close an open slot
            i = int(rng.integers(0, len(pinned)))
            for s, mr in zip(sides, pinned.pop(i)):
                for pid, _ in mr.pages:
                    s[0].decref(pid)
                s[2].release(mr)
        elif op == 5:               # a snapshot at a page boundary
            b = PS * int(rng.integers(1, plen // PS + 1)) \
                if plen >= PS else PS
            toks = np.resize(toks, max(b, plen)).astype(np.int32)
            wants = [s[2].wants_snapshot(toks, b) for s in sides]
            assert wants[0] == wants[1]
            got = [s[2].insert_snapshot(toks, b, _snap(seed + b, s is port))
                   for s in sides]
            assert got[0] == got[1]
        elif op == 6:
            for s in sides:
                s[2].spill_all()
        _same_state(port, ref)
    for mrs in pinned:
        for s, mr in zip(sides, mrs):
            for pid, _ in mr.pages:
                s[0].decref(pid)
            s[2].release(mr)
    while True:
        ev = [s[2].evict_one() for s in sides]
        assert ev[0] == ev[1]
        _same_state(port, ref)
        if not ev[0]:
            break
    assert port[2].node_count == 0
    assert port[0].free_pages == port[0].num_pages
    assert port[2].hit_tokens > 0 and port[2].spills > 0


@pytest.mark.parametrize("seed", range(6))
def test_radix_match_vs_brute_force_lcp(seed):
    """The tree finds every full page a registered prompt shares, up to the
    one-uncached-token cap (a brute-force longest-common-prefix
    reference), with the reference's matches; a drain leaks nothing."""
    rng = np.random.default_rng(100 + seed)
    vocab = (2, 3, 50)[seed % 3]
    pool, dev, cache = _radix()
    jpool, jdev, jcache = _ref_radix()
    registered = []
    for _ in range(10):
        plen = int(rng.integers(1, 5 * PS))
        toks = rng.integers(0, vocab, plen).astype(np.int32)
        mr, jmr = cache.match(toks, plen - 1), jcache.match(toks, plen - 1)
        _same_match(mr, jmr)
        best = 0
        for r in registered:
            n, lim = 0, min(len(toks), len(r)) // PS
            while n < lim and np.array_equal(toks[n * PS:(n + 1) * PS],
                                             r[n * PS:(n + 1) * PS]):
                n += 1
            best = max(best, min(n, len(r) // PS))
        assert sum(1 for _, f in mr.pages if f == PS) >= \
            min(best, (plen - 1) // PS)
        cache.abandon(mr, plen)
        jcache.abandon(jmr, plen)
        _, held = _submit(pool, dev, cache, toks, check=True)
        _submit(jpool, jdev, jcache, toks)
        if len(held) == -(-plen // PS):
            registered.append(toks)
    while cache.evict_one():
        assert jcache.evict_one()
    assert not jcache.evict_one()
    assert cache.node_count == 0 and pool.free_pages == pool.num_pages


@pytest.mark.parametrize("seed", range(6))
def test_chain_equals_reference_on_seeded_sequences(seed):
    """`ChainPrefixCache` against the reference's on seeded request
    sequences (tiny vocabularies force collisions): the same matches,
    counters, refcounts and free lists; a drain frees every page."""
    rng = np.random.default_rng(200 + seed)
    vocab = (2, 3, 50)[seed % 3]
    pool, jpool = PagePool(64, PS), JP.PagePool(64, PS)
    cache, jcache = ChainPrefixCache(pool), JP.ChainPrefixCache(jpool)
    dev, jdev = _PortDevice(64), _RefDevice(64)
    for _ in range(10):
        plen = int(rng.integers(1, 4 * PS))
        toks = rng.integers(0, vocab, plen).astype(np.int32)
        mr, held = _submit(pool, dev, cache, toks, check=True)
        jmr, jheld = _submit(jpool, jdev, jcache, toks)
        assert (mr.pages, mr.covered, held) == (jmr.pages, jmr.covered, jheld)
        for name in COUNTERS:
            assert getattr(cache, name) == getattr(jcache, name), name
        assert pool.ref.tolist() == jpool.ref.tolist()
        assert pool._free == jpool._free
        pool.check()
    while cache.evict_one():
        assert jcache.evict_one()
        pool.check()
    assert pool.free_pages == pool.num_pages


# ---------------------------------------------------------------------------
# the reference's deterministic cache tests, on the port
# ---------------------------------------------------------------------------

def test_radix_pinned_never_evicted():
    pool, dev, cache = _radix(num_pages=8)
    toks = np.arange(2 * PS, dtype=np.int32)
    _submit(pool, dev, cache, toks)
    mr = cache.match(toks, 2 * PS - 1)          # pins the deepest node
    assert cache.evictable() == 0
    assert not cache.evict_one()
    for pid, _ in mr.pages:
        pool.decref(pid)
    assert not cache.evict_one()                # the pin alone protects it
    cache.release(mr)
    assert cache.evict_one()
    while cache.evict_one():
        pass
    pool.check()
    assert pool.free_pages == pool.num_pages


def test_radix_eviction_is_lru_leaf_first():
    """Two sibling branches: the least recently touched leaf goes first,
    and evicting a leaf makes its parent evictable next."""
    pool, dev, cache = _radix(num_pages=16)
    shared = np.arange(PS, dtype=np.int32)
    a = np.concatenate([shared, np.full(PS, 90, np.int32)])
    b = np.concatenate([shared, np.full(PS, 91, np.int32)])
    _submit(pool, dev, cache, a)
    _submit(pool, dev, cache, b)                # splits: shared + 2 leaves
    assert cache.node_count == 3
    cache.abandon(cache.match(a, 2 * PS - 1), 2 * PS)
    free0 = pool.free_pages
    assert cache.evict_one()
    assert pool.free_pages == free0 + 1
    mr = cache.match(a, 2 * PS - 1)
    assert sum(f for _, f in mr.pages) >= 2 * PS - 1
    cache.abandon(mr, 2 * PS)
    mr = cache.match(b, 2 * PS - 1)
    assert mr.covered == PS                     # only the shared page left
    cache.abandon(mr, 2 * PS)
    while cache.evict_one():
        pass
    cache.check()
    pool.check()
    assert pool.free_pages == pool.num_pages


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_spill_rehydrate_roundtrip_byte_identical(dtype):
    """Evicting a node writes its device rows (and snapshot) to the host
    tier as torch tensors; a later match re-attaches them bit for bit,
    bf16 included (whose rows numpy could not hold)."""
    spill = SpillTier(16)
    pool, dev, cache = _radix(num_pages=8, spill=spill, dtype=dtype)
    toks = np.arange(3 * PS, dtype=np.int32)
    _, held = _submit(pool, dev, cache, toks)
    gen = torch.Generator().manual_seed(0)
    dev.rows.copy_(torch.randn(dev.rows.shape, generator=gen).to(dtype))
    snap = {"s": torch.randn(5, generator=gen).to(dtype),
            "last": torch.ones(2, dtype=dtype)}
    assert cache.insert_snapshot(toks, 2 * PS,
                                 {k: v.clone() for k, v in snap.items()})
    assert cache.snapshot_bytes == 7 * dtype.itemsize
    want = [dev.rows[pid * PS:(pid + 1) * PS].clone() for pid in held[:2]]
    while cache.evict_one():
        pass
    assert cache.node_count == 0 and pool.free_pages == pool.num_pages
    assert len(spill) == 3 and cache.spills >= 3
    assert all(e["pages"]["rows"].dtype == dtype for _, e in spill.items())
    dev.rows.fill_(-1)                          # scramble the device pools
    mr = cache.match(toks, 3 * PS - 1, need_state=True)
    assert cache.rehydrates == 2
    assert mr.covered == 2 * PS and mr.snapshot is not None
    for k in snap:
        assert torch.equal(mr.snapshot[k], snap[k])
    got = torch.cat([dev.rows[pid * PS:(pid + 1) * PS]
                     for pid, _ in mr.pages])
    bits = lambda t: t.view(torch.int16) if dtype == torch.bfloat16 else t
    assert torch.equal(bits(got), bits(torch.cat(want)))
    cache.abandon(mr, 3 * PS)
    cache.check()
    while cache.evict_one():
        pass
    pool.check()
    assert pool.free_pages == pool.num_pages


def test_spill_tier_writeback_queue_bound():
    """An O(1) LRU writeback queue: overflowing drops the least recently
    written entry, putting again refreshes recency."""
    tier = SpillTier(max_entries=3)
    for i in range(3):
        tier.put(np.asarray([i], np.int32), snap={"x": torch.tensor([i])})
    tier.put(np.asarray([0], np.int32), snap={"x": torch.tensor([10])})
    tier.put(np.asarray([3], np.int32), snap={"x": torch.tensor([3])})
    assert len(tier) == 3 and tier.evicted == 1
    assert tier.peek(np.asarray([1], np.int32)) is None
    assert int(tier.peek(np.asarray([0], np.int32))["snap"]["x"][0]) == 10
    assert [int(t[0]) for t, _ in tier.items()] == [2, 0, 3]


def test_stateless_snapshot_cache():
    """Page-less archs (rwkv): nodes carry snapshots only, need_state
    matching clamps to the deepest snapshot boundary, and the snapshot
    budget spills the oldest blob to the tier."""
    pool = PagePool(1, PS)
    spill = SpillTier(8)
    cache = RadixPrefixCache(pool, has_pages=False, spill=spill,
                             snapshot_budget=2)
    toks = np.arange(4 * PS, dtype=np.int32)
    assert cache.wants_snapshot(toks, PS)
    assert not cache.wants_snapshot(toks, PS + 1)       # not page-aligned
    cache.insert_snapshot(toks, PS, {"s": torch.full((3,), 1.0)})
    assert not cache.wants_snapshot(toks, PS)           # first write wins
    cache.insert_snapshot(toks, 3 * PS, {"s": torch.full((3,), 3.0)})
    mr = cache.match(toks, 4 * PS - 1, need_state=True)
    assert mr.covered == 3 * PS and float(mr.snapshot["s"][0]) == 3.0
    assert not mr.pages
    cache.release(mr)
    div = toks.copy()
    div[2 * PS] += 1
    mr = cache.match(div, 4 * PS - 1, need_state=True)
    assert mr.covered == PS and float(mr.snapshot["s"][0]) == 1.0
    cache.abandon(mr, len(div))
    cache.insert_snapshot(toks, 2 * PS, {"s": torch.full((3,), 2.0)})
    assert len(cache._snaps) == 2 and cache.spills == 1 and len(spill) == 1
    assert cache.snapshot_bytes == 2 * 3 * 4
    cache.check()
    while cache.evict_one():
        pass
    assert cache.node_count == 0
    pool.check()


def test_partial_continuations_coexist_only_in_radix():
    """Content-distinct partial continuations of one full-page spine: the
    radix tree keeps both, the chain baseline only the first."""
    base = np.arange(PS, dtype=np.int32)
    p1 = np.concatenate([base, np.asarray([50, 51], np.int32)])
    p2 = np.concatenate([base, np.asarray([60, 61], np.int32)])
    pool, dev, cache = _radix(num_pages=8)
    _submit(pool, dev, cache, p1)
    _submit(pool, dev, cache, p2)
    for q in (p1, p2):
        mr = cache.match(np.append(q, 7).astype(np.int32), len(q))
        assert mr.covered == len(q), q
        _check_content(dev, mr, q)
        cache.abandon(mr, len(q) + 1)
    chain_pool = PagePool(8, PS)
    chain = ChainPrefixCache(chain_pool)
    pids = [chain_pool.alloc() for _ in range(3)]
    chain.insert_pages(p1, 1, pids[:1], 0)
    chain.insert_partial(p1, pids[1])
    assert chain.insert_partial(p2, pids[2]) is False   # slot taken
    mr = chain.match(np.append(p2, 7).astype(np.int32), len(p2))
    assert mr.covered == PS
    chain.abandon(mr, len(p2) + 1)
    while cache.evict_one():
        pass
    pool.check()
    assert pool.free_pages == pool.num_pages


def test_partial_slots_lru_bounded():
    """At most `partial_slots` continuations per spine, LRU-displaced
    beyond that."""
    pool, dev, cache = _radix(num_pages=16)
    base = np.arange(PS, dtype=np.int32)
    tails = [np.concatenate([base, np.asarray([t, t + 1], np.int32)])
             for t in (50, 60, 70)]
    for t in tails:
        _submit(pool, dev, cache, t)
    assert cache.node_count == 3            # spine + partial_slots leaves
    mr = cache.match(np.append(tails[0], 7).astype(np.int32), len(tails[0]))
    assert mr.covered == PS
    cache.abandon(mr, len(tails[0]) + 1)
    for t in tails[1:]:
        mr = cache.match(np.append(t, 7).astype(np.int32), len(t))
        assert mr.covered == len(t), t
        cache.abandon(mr, len(t) + 1)
    while cache.evict_one():
        pass
    pool.check()
    assert pool.free_pages == pool.num_pages


@pytest.mark.parametrize("kind", ["radix", "chain"])
def test_exact_multiple_match_downgrades_last_full_page(kind):
    """fill == 0 edge: an identical exact-multiple prompt reuses the
    registrant's LAST full page as a ps-1 partial match; a prompt whose
    last page differs does not; a longer prompt still matches both pages
    in full."""
    if kind == "radix":
        pool, _, cache = _radix(num_pages=6)
    else:
        pool = PagePool(6, PS)
        cache = ChainPrefixCache(pool)
    toks = np.asarray(range(2 * PS), np.int32)
    pids = [pool.alloc(), pool.alloc()]
    cache.insert_pages(toks, 2, pids, 0)
    mr = cache.match(toks, len(toks) - 1)
    assert mr.covered == 2 * PS - 1
    assert [f for _, f in mr.pages] == [PS, PS - 1]
    assert mr.pages[-1][0] == pids[-1]
    assert pool.ref[pids[-1]] == 3      # holder + cache + this match
    cache.abandon(mr, len(toks))
    diff = toks.copy()
    diff[-1] += 1
    mr = cache.match(diff, len(diff) - 1)
    assert mr.covered == PS and [f for _, f in mr.pages] == [PS]
    for pid, _ in mr.pages:
        pool.decref(pid)
    cache.release(mr)
    longer = np.concatenate([toks, np.asarray([7, 8], np.int32)])
    mr = cache.match(longer, len(longer) - 1)
    assert mr.covered == 2 * PS and [f for _, f in mr.pages] == [PS, PS]
    for pid, _ in mr.pages:
        pool.decref(pid)
    cache.release(mr)
    for pid in pids:
        pool.decref(pid)
    while cache.evict_one():
        pass
    pool.check()
    assert pool.free_pages == 6


def test_exact_multiple_registers_no_partial():
    pool, _, cache = _radix(num_pages=4)
    toks = np.arange(2 * PS, dtype=np.int32)
    pids = [pool.alloc(), pool.alloc()]
    cache.insert_pages(toks, 2, pids, 0)
    refs, nodes = pool.ref.copy(), cache.node_count
    assert cache.insert_partial(toks, pids[-1]) is False
    assert (pool.ref == refs).all() and cache.node_count == nodes
    for pid in pids:
        pool.decref(pid)
    while cache.evict_one():
        pass
    pool.check()
    assert pool.free_pages == 4


def test_prefix_match_is_content_checked():
    """A partial-page entry only matches identical token content."""
    pool, _, cache = _radix(num_pages=4)
    toks = np.asarray([1, 2, 3, 4, 5, 6], np.int32)     # 1 full + 2 partial
    pids = [pool.alloc(), pool.alloc()]
    cache.insert_pages(toks, 1, pids, 0)
    cache.insert_partial(toks, pids[1])
    for q, covered, fills in (([1, 2, 3, 4, 5, 6, 9], 6, [PS, 2]),
                              ([1, 2, 3, 4, 5, 7, 9], PS, [PS])):
        q = np.asarray(q, np.int32)
        mr = cache.match(q, len(q) - 1)
        assert mr.covered == covered and [f for _, f in mr.pages] == fills
        for pid, _ in mr.pages:
            pool.decref(pid)
        cache.release(mr)
    for pid in pids:
        pool.decref(pid)
    while cache.evict_one():
        pass
    pool.check()
    assert pool.free_pages == 4


def test_tree_nbytes_counts_torch_and_numpy():
    blob = {"a": torch.zeros((2, 3), dtype=torch.bfloat16),
            "b": {"c": np.zeros(4, np.float32)}, "d": {}}
    assert PP._tree_nbytes(blob) == 2 * 3 * 2 + 4 * 4
    assert PP._tree_nbytes(None) == 0


def test_page_pool_chaos_names_item_13b():
    """Item 13b's alloc faults: every alloc draw fires, in the port's pool
    and the reference's, before any change to the pool; a copy-on-write
    split's alloc too. Without faults both go on as before."""
    from repro.runtime import FaultSchedule as JFaultSchedule
    from repro_torch.runtime import FaultSchedule, InjectedFault
    from repro.runtime import InjectedFault as JInjectedFault
    pools = ((PagePool(3, PS, chaos=FaultSchedule(0)), InjectedFault),
             (JP.PagePool(3, PS, chaos=JFaultSchedule(0)), JInjectedFault))
    for pool, Fault in pools:
        shared = pool.alloc()
        pool.incref(shared)
        pool.chaos.rates["alloc"] = 1.0
        before = (pool.ref.tolist(), list(pool._free), pool.peak_in_use)
        for op in (pool.alloc, lambda: pool.cow_split(shared)):
            with pytest.raises(Fault, match="injected alloc fault"):
                op()
            assert (pool.ref.tolist(), list(pool._free),
                    pool.peak_in_use, pool.cow_splits) == before + (0,)
        pool.chaos.rates["alloc"] = 0.0
        assert pool.cow_split(shared) == 1 and pool.ref.tolist() == [1, 1, 0]
        assert pool.chaos.sequence() == [("alloc", 1, None),
                                         ("alloc", 2, None)]


# ---------------------------------------------------------------------------
# read_pool_rows / write_pool_rows on bridged pools
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,dtype", [("llama3-8b", "float32"),
                                        ("gemma3-4b", "float32"),
                                        ("jamba-1.5-large-398b", "bfloat16")])
def test_pool_rows_match_reference(arch, dtype):
    """A page read out of every layer's pool and written into another page
    gives the reference's rows and pools bitwise (gemma's tail and
    jamba's mamba sublayers hold no pool: empty subtrees)."""
    jcfg = dataclasses.replace(jget(arch), dtype=dtype)
    pcfg = dataclasses.replace(pget(arch), dtype=dtype)
    _, jpools = JD.init_serve_cache(jcfg, 2, 16, 4, PS)
    rng = np.random.default_rng(5)
    jpools = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(a.dtype), jpools)
    pools = bridge.to_torch(jpools)
    _, fresh = PD.init_serve_cache(pcfg, 2, 16, 4, PS, device="cpu")
    assert jax.tree.structure(bridge.to_numpy(fresh)) == \
        jax.tree.structure(bridge.to_numpy(pools))
    rows = PD.read_pool_rows(pools, 1 * PS, PS)
    jrows = JD.read_pool_rows(jpools, 1 * PS, PS)
    for a, b in zip(jax.tree.leaves(bridge.to_numpy(rows)),
                    jax.tree.leaves(jrows)):
        assert a.dtype == b.dtype and a.tobytes() == np.asarray(b).tobytes()
    host = tree_map(lambda a: a.clone(), rows)
    out = PD.write_pool_rows(pools, host, 3 * PS)
    assert all(a is b for a, b in zip(tree_leaves(out), tree_leaves(pools)))
    jout = JD.write_pool_rows(jpools, jrows, 3 * PS)
    for a, b in zip(jax.tree.leaves(bridge.to_numpy(pools)),
                    jax.tree.leaves(jout)):
        assert a.tobytes() == np.asarray(b).tobytes()
    if dtype == "bfloat16":     # f32 rows are cast to the pool's dtype
        PD.write_pool_rows(pools, tree_map(lambda a: a.float(), host),
                           2 * PS)
        for a, b in zip(tree_leaves(PD.read_pool_rows(pools, 2 * PS, PS)),
                        tree_leaves(host)):
            assert a.dtype == torch.bfloat16 and torch.equal(
                a.view(torch.int16), b.view(torch.int16))
