"""Page-granular KV-cache bookkeeping: refcounted page pool, radix-tree
prefix reuse, and a host-memory spill tier. The port's own copy of the
reference package's `serve/paging.py`.

Pure-python/numpy state (no torch import): the engine asks the pool for
page ids and keeps the device-side pools (`models/decoding.py` paged
leaves) in sync. A *page* is `page_size` consecutive token rows of every
paged KV leaf; a request's logical page i lives at physical page
`page_table[i]` in every layer's pool (one id indexes all layers).

Refcount discipline:

- a live request holds one reference per page in its table;
- the prefix cache holds one reference per page owned by a tree node;
- a page with refcount 0 is on the free list. `decref` below zero raises —
  double-frees are bugs, not warnings.

Copy-on-write: writing token rows into a page with refcount > 1 must first
`cow_split` it — allocate a fresh exclusive page, drop one reference on the
shared one — and copy the device rows. The engine triggers this when a
request appends to a page it shares with the prefix cache (or another
request): e.g. the request that *registered* a partially-filled last prompt
page COWs it on its first decode write, leaving the cached page frozen with
prompt-only content.

Radix lifecycle (SGLang's RadixAttention discipline, over token pages)
----------------------------------------------------------------------
``RadixPrefixCache`` keys reuse by token *content*: tree edges are runs of
whole token pages (children keyed by their first page's token bytes), so a
lookup walks arbitrary shared prefixes — not just whole registered chains —
and diverging prompts share every page up to their split point.

    insert    — ``insert_pages`` descends the tree, SPLITTING a node at the
                page boundary where the new prompt diverges, then hangs the
                uncovered pages off the split point (one pool reference per
                page). ``insert_snapshot`` attaches a recurrent-state blob
                (ring k/v, mamba h+conv, rwkv S+last — see
                ``models/decoding.py`` CacheFamily) to the node ending at a
                page boundary, so state families join prefix sharing; for
                page-less archs (rwkv) the nodes carry no pages at all.
    match     — walks the longest page-aligned shared prefix under the
                caller's cap, increfs every matched page, and — for state
                families — clamps coverage to the deepest snapshot
                boundary, returning the blob to restore. At most one
                partial-page continuation (content-compared) or an
                exact-page-multiple downgrade extends the match.
    pin       — every match pins its deepest node (`pins` count); pinned
                nodes and nodes whose pages a live slot still references
                (refcount > 1) are never evicted.
    evict     — an explicit unpinned-leaf LRU: every touch pushes a
                (stamp, node) entry on a lazy-invalidation heap, so
                ``evict_one`` is O(depth) amortized. Evicting a leaf may
                promote its parent to a leaf (pushed back on the heap).
    spill     — evicted full-page nodes write their device page rows
                (via the engine's reader callback) and snapshot blob into
                the host ``SpillTier`` keyed by the full token prefix, an
                O(1) LRU writeback queue. Partial pages are dropped, not
                spilled (their content is not page-aligned addressable).
    rehydrate — a match that misses in the tree consults the spill tier:
                a hit allocates a free page, writes the saved rows back
                into the device pools (writer callback), and re-attaches
                the node — so a restarted engine (or a later ``run()``)
                serves its system-prompt tree instead of starting cold.
                ``checkpoint/manager.py`` serializes the tier to disk for
                ``--prefix-persist``.

Host blobs (spilled page rows, snapshots) are trees of CPU torch tensors in
the engine; the caches only store, count (`_tree_nbytes`) and hand them
back. Tokens stay numpy int32 and are keyed by their bytes.

``ChainPrefixCache`` keeps the whole-chain rolling-crc32 design as the
comparison baseline (`prefix_mode="chain"`): one partial continuation per
chain, no snapshots, no spill, fully-paged archs only.
"""
from __future__ import annotations

import dataclasses
import heapq
import zlib
from collections import OrderedDict
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.runtime.chaos import FaultKind, InjectedFault

__all__ = ["PagePool", "RadixPrefixCache", "ChainPrefixCache", "SpillTier",
           "MatchResult"]


class PagePool:
    """Fixed set of `num_pages` refcounted pages of `page_size` token rows.

    `chaos` is an optional ``runtime.chaos.FaultSchedule``: when set, its
    ``alloc`` draws make `alloc` raise ``InjectedFault`` BEFORE any state
    changes — the deterministic stand-in for a transient allocation
    failure, which callers (the engine's retry path) must absorb without
    corrupting the refcount discipline."""

    def __init__(self, num_pages: int, page_size: int, chaos=None):
        assert num_pages >= 1 and page_size >= 1
        self.num_pages = num_pages
        self.page_size = page_size
        self.chaos = chaos
        self.ref = np.zeros((num_pages,), np.int32)
        # LIFO free list: reuse the hottest page first
        self._free = list(range(num_pages - 1, -1, -1))
        self.peak_in_use = 0
        self.cow_splits = 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.num_pages - len(self._free)

    def alloc(self) -> int:
        """Take a free page (refcount 1). Raises when exhausted — callers
        gate allocations on reservations + cache eviction, so running
        dry here is a bookkeeping bug. An injected ``alloc`` fault raises
        before any mutation, so a caught fault leaves the pool intact."""
        if self.chaos is not None:
            self.chaos.maybe_raise(FaultKind.ALLOC)
        if not self._free:
            raise RuntimeError("page pool exhausted (reservation bug)")
        pid = self._free.pop()
        assert self.ref[pid] == 0
        self.ref[pid] = 1
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return pid

    def incref(self, pid: int) -> None:
        assert self.ref[pid] > 0, f"incref of free page {pid}"
        self.ref[pid] += 1

    def decref(self, pid: int) -> None:
        if self.ref[pid] <= 0:
            raise RuntimeError(f"double-free of page {pid}")
        self.ref[pid] -= 1
        if self.ref[pid] == 0:
            self._free.append(pid)

    def cow_split(self, pid: int) -> int:
        """Resolve a write to shared page `pid`: allocate an exclusive
        replacement and release one reference on the original. The caller
        must copy the device rows pid -> new before writing."""
        assert self.ref[pid] >= 2, f"cow_split of exclusive page {pid}"
        new = self.alloc()
        self.decref(pid)
        self.cow_splits += 1
        return new

    def check(self) -> None:
        """Invariant audit (used by the property tests): every page is
        either free with refcount 0 or in use with refcount > 0, and the
        free list holds no duplicates."""
        free = set(self._free)
        assert len(free) == len(self._free), "duplicate page on free list"
        for pid in range(self.num_pages):
            if pid in free:
                assert self.ref[pid] == 0, f"freed page {pid} still referenced"
            else:
                assert self.ref[pid] > 0, f"leaked page {pid} (ref 0, not free)"


def _as_tokens(tokens) -> np.ndarray:
    return np.ascontiguousarray(tokens, np.int32)


def _tree_nbytes(tree) -> int:
    """Bytes of a host blob: nested dicts of torch tensors (numel x
    element_size: numpy has no bf16) or numpy arrays."""
    if tree is None:
        return 0
    if isinstance(tree, dict):
        return sum(_tree_nbytes(v) for v in tree.values())
    if hasattr(tree, "element_size"):
        return int(tree.numel() * tree.element_size())
    return int(np.asarray(tree).nbytes)


@dataclasses.dataclass
class MatchResult:
    """One prefix-cache lookup. `pages` is a list of (pid, fill) in logical
    order with one pool reference taken per page (the caller owns them —
    `abandon` rolls everything back), `covered` the token count they (plus
    any snapshot) hold, `snapshot` the host recurrent-state blob to restore
    at token `covered` (state families only). The deepest node stays pinned
    until `release` (slot close) or `abandon` (admission rollback)."""
    pages: list
    covered: int
    snapshot: Any = None
    node: Any = None        # pinned tree node (None for the chain baseline)
    state: bool = False     # lookup asked for a snapshot (state family)


class SpillTier:
    """Host-memory spill target for evicted radix nodes: an O(1) LRU
    writeback queue (OrderedDict move_to_end/popitem — same discipline as
    the tree's unpinned-leaf LRU) of per-page-boundary entries keyed by the
    full token prefix. Each entry holds the device page rows (a tree of
    host tensors) and/or the recurrent-state snapshot at that boundary. The engine
    owns ONE tier across `run()` calls, and `checkpoint/manager.py`
    serializes it for `--prefix-persist`."""

    def __init__(self, max_entries: int = 4096):
        assert max_entries >= 1
        self.max_entries = max_entries
        self._entries: OrderedDict[bytes, dict] = OrderedDict()
        self.puts = 0
        self.takes = 0
        self.evicted = 0        # entries dropped off the writeback queue

    def __len__(self) -> int:
        return len(self._entries)

    def put(self, prefix_tokens, *, pages=None, snap=None) -> None:
        """Merge (pages, snap) into the entry for this token prefix and mark
        it most-recently-written; oldest entries fall off the queue."""
        if pages is None and snap is None:
            return
        toks = _as_tokens(prefix_tokens)
        key = toks.tobytes()
        ent = self._entries.get(key)
        if ent is None:
            ent = {"tokens": toks.copy()}
            self._entries[key] = ent
        if pages is not None:
            ent["pages"] = pages
        if snap is not None:
            ent["snap"] = snap
        self._entries.move_to_end(key)
        self.puts += 1
        while len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)
            self.evicted += 1

    def peek(self, prefix_tokens) -> Optional[dict]:
        return self._entries.get(_as_tokens(prefix_tokens).tobytes())

    def take(self, prefix_tokens) -> Optional[dict]:
        ent = self._entries.pop(_as_tokens(prefix_tokens).tobytes(), None)
        if ent is not None:
            self.takes += 1
        return ent

    def items(self):
        """(tokens, entry) in LRU order, oldest first — the serialization
        hook for `checkpoint.manager.save_spill_tier` (duck-typed so the
        checkpoint module stays serve-import-free)."""
        for ent in self._entries.values():
            yield ent["tokens"], ent

    def clear(self) -> None:
        self._entries.clear()


class _Node:
    """One radix edge: a run of whole token pages (or a sub-page partial
    continuation). `snapshot` is the recurrent state at the node's END
    boundary; splits keep it on the bottom half, so that stays true."""
    __slots__ = ("key", "pages", "parent", "children", "partials",
                 "snapshot", "pins", "stamp", "partial")

    def __init__(self, key: np.ndarray, parent: Optional["_Node"],
                 pages: Optional[list] = None, partial: bool = False):
        self.key = key                  # np.int32 tokens this edge covers
        self.pages = pages              # page ids (None for page-less archs)
        self.parent = parent
        self.children: dict[bytes, _Node] = {}
        self.partials: list[_Node] = []
        self.snapshot = None
        self.pins = 0
        self.stamp = 0
        self.partial = partial


class RadixPrefixCache:
    """Radix tree over token pages for cross-request prefix reuse (see the
    module docstring for the full insert/match/pin/evict/spill/rehydrate
    lifecycle). `reader(pid) -> host tree` / `writer(pid, host tree)` are
    the engine callbacks that move device page rows to/from the spill tier;
    `has_pages=False` serves page-less (pure recurrent-state) archs, whose
    nodes carry snapshots only."""

    def __init__(self, pool: PagePool, *, has_pages: bool = True,
                 reader: Optional[Callable[[int], Any]] = None,
                 writer: Optional[Callable[[int, Any], None]] = None,
                 spill: Optional[SpillTier] = None,
                 snapshot_budget: int = 256, max_nodes: int = 4096,
                 partial_slots: int = 2):
        assert snapshot_budget >= 1 and max_nodes >= 2 and partial_slots >= 1
        self.pool = pool
        self.has_pages = has_pages
        self.spill = spill
        self._reader = reader
        self._writer = writer
        self._ps = pool.page_size
        self._root = _Node(np.zeros((0,), np.int32), None)
        self._lru: list = []            # (stamp, seq, node) lazy-invalidation heap
        self._clock = 0
        self._nodes = 0                 # non-root node count
        self._snaps: OrderedDict[int, _Node] = OrderedDict()  # id(node) -> node
        self.snapshot_budget = snapshot_budget
        self.max_nodes = max_nodes
        self.partial_slots = partial_slots
        # statistics
        self.hit_tokens = 0
        self.lookup_tokens = 0
        self.lookups = 0
        self.state_lookups = 0      # lookups with need_state (state family)
        self.snapshot_hits = 0
        self.snapshots_stored = 0
        self.snapshot_bytes = 0
        self.spills = 0
        self.rehydrates = 0

    def __len__(self) -> int:
        return self._nodes

    @property
    def node_count(self) -> int:
        return self._nodes

    # -- LRU plumbing ------------------------------------------------------

    def _touch(self, node: _Node) -> None:
        self._clock += 1
        node.stamp = self._clock
        heapq.heappush(self._lru, (node.stamp, self._clock, node))

    def _push(self, node: _Node) -> None:
        """Re-announce `node` on the heap WITHOUT refreshing its recency
        (used when an eviction turns it into a leaf, or when a blocked
        entry is put back)."""
        self._clock += 1
        heapq.heappush(self._lru, (node.stamp, self._clock, node))

    # -- tree walking ------------------------------------------------------

    def _match_pages(self, child: _Node, tokens: np.ndarray, covered: int,
                     limit: int) -> int:
        """Tokens of `child.key` matching tokens[covered:], whole pages
        only, capped at `limit` tokens (rounded down to a page)."""
        ps = self._ps
        k = min(len(child.key), limit - (limit % ps))
        m = 0
        while m < k and child.key[m:m + ps].tobytes() == \
                tokens[covered + m:covered + m + ps].tobytes():
            m += ps
        return m

    def _split(self, node: _Node, at: int) -> _Node:
        """Split a full node at token offset `at` (page multiple, interior).
        The TOP half takes the first pages and replaces `node` under its
        parent; `node` keeps the tail — and its snapshot (END boundary),
        partials, and pins, which all describe the original end."""
        ps = self._ps
        assert 0 < at < len(node.key) and at % ps == 0 and not node.partial
        top = _Node(node.key[:at].copy(), node.parent,
                    pages=(node.pages[:at // ps]
                           if node.pages is not None else None))
        node.parent.children[top.key[:ps].tobytes()] = top
        node.key = node.key[at:].copy()
        if node.pages is not None:
            node.pages = node.pages[at // ps:]
        node.parent = top
        top.children[node.key[:ps].tobytes()] = node
        top.stamp = node.stamp
        self._nodes += 1
        self._push(top)
        return top

    def _descend(self, tokens: np.ndarray, target: int):
        """Walk full-page edges toward token `target` (page multiple),
        splitting at divergence/cap points so the returned node ends
        exactly at the deepest matched page boundary <= target.
        Returns (node, covered)."""
        ps = self._ps
        node, covered = self._root, 0
        while covered < target:
            child = node.children.get(tokens[covered:covered + ps].tobytes())
            if child is None:
                break
            m = self._match_pages(child, tokens, covered, target - covered)
            if m == 0:
                break
            if m < len(child.key):
                child = self._split(child, m)
            node = child
            covered += m
            self._touch(node)
        return node, covered

    def _locate(self, tokens: np.ndarray, boundary: int):
        """No-split read-only walk to token `boundary` (page multiple).
        Returns (node, off) with `boundary == node_start + off` (off ==
        len(node.key) means exactly the node end), or None when the tree
        does not cover [0, boundary)."""
        node, c = self._root, 0
        while c < boundary:
            child = node.children.get(tokens[c:c + self._ps].tobytes())
            if child is None:
                return None
            m = self._match_pages(child, tokens, c, boundary - c)
            if m == 0:
                return None
            node = child
            c += m
            if m < len(child.key):
                return (node, m) if c == boundary else None
        return node, (len(node.key) if node is not self._root else 0)

    def _prefix_of(self, node: _Node) -> np.ndarray:
        parts = []
        n = node
        while n is not None:
            parts.append(n.key)
            n = n.parent
        return np.concatenate(list(reversed(parts)))

    # -- match -------------------------------------------------------------

    def match(self, tokens, max_tokens: int, *,
              need_state: bool = False) -> MatchResult:
        """Longest cached prefix of `tokens`, capped at `max_tokens` tokens
        (callers keep >= 1 prompt token uncached: something must produce the
        first sampled token's logits). With `need_state`, coverage is
        clamped to the deepest snapshot boundary — pages beyond it are
        useless without the recurrent state that accompanies them."""
        ps = self._ps
        tokens = _as_tokens(tokens)
        self.lookup_tokens += len(tokens)
        self.lookups += 1
        if need_state:
            # snapshot_hit_rate denominates by these, not all lookups:
            # attention-family traffic never asks for snapshots
            self.state_lookups += 1
        node, covered = self._root, 0
        pages: list[int] = []
        snap_node, snap_at = None, 0
        at_end, off_last = True, 0
        while covered + ps <= max_tokens:
            key = tokens[covered:covered + ps].tobytes()
            child = node.children.get(key)
            if child is None and self.spill is not None:
                child = self._rehydrate(node, tokens, covered)
            if child is None:
                break
            m = self._match_pages(child, tokens, covered, max_tokens - covered)
            if m == 0:
                break
            if child.pages is not None:
                pages.extend(child.pages[:m // ps])
            covered += m
            self._touch(child)
            node = child
            if m < len(child.key):
                at_end, off_last = False, m
                break
            if child.snapshot is not None:
                snap_node, snap_at = child, covered

        snapshot, pin = None, (node if covered else None)
        out: list[tuple[int, int]] = [(pid, ps) for pid in pages]
        if need_state:
            # only state-accompanied coverage is usable: clamp to the
            # deepest snapshot boundary and drop the pages beyond it
            covered = snap_at
            out = out[:snap_at // ps]
            pin = snap_node
            if snap_node is not None:
                snapshot = snap_node.snapshot
                self.snapshot_hits += 1
                self._snaps.move_to_end(id(snap_node))
        else:
            matched_partial = False
            if at_end:
                best = None
                for pn in node.partials:
                    fill = len(pn.key)
                    if 0 < fill <= max_tokens - covered and \
                            (best is None or fill > len(best.key)) and \
                            pn.key.tobytes() == \
                            tokens[covered:covered + fill].tobytes():
                        best = pn
                if best is not None:
                    self._touch(best)
                    out.append((best.pages[0], len(best.key)))
                    covered += len(best.key)
                    pin, matched_partial = best, True
            if not matched_partial and covered + ps == len(tokens) \
                    and covered < max_tokens:
                # exact-page-multiple edge: the prompt's LAST page is cached
                # as a full page (its registrant had fill == 0, so no partial
                # node exists), but the loop above stopped at the >= 1
                # uncached-token cap. Attach that page as a partial match of
                # its first max_tokens - covered rows — absolute positions
                # make the prefix of a cached page freely readable.
                want = tokens[covered:covered + ps].tobytes()
                down = None
                if at_end:
                    nxt = node.children.get(want)
                    if nxt is None and self.spill is not None:
                        nxt = self._rehydrate(node, tokens, covered)
                    if nxt is not None and nxt.pages is not None:
                        self._touch(nxt)
                        down = nxt.pages[0]
                        pin = nxt
                elif node.pages is not None and \
                        node.key[off_last:off_last + ps].tobytes() == want:
                    down = node.pages[off_last // ps]
                if down is not None:
                    out.append((down, max_tokens - covered))
                    covered = max_tokens

        for pid, _ in out:
            self.pool.incref(pid)
        if pin is not None:
            pin.pins += 1
        self.hit_tokens += covered
        return MatchResult(pages=out, covered=covered, snapshot=snapshot,
                           node=pin, state=need_state)

    def abandon(self, mr: MatchResult, lookup_tokens: int) -> None:
        """Roll back a `match` whose admission was deferred: release the
        page references, the pin, AND the hit/lookup counters, so a retried
        admission does not inflate the prefix statistics."""
        for pid, _ in mr.pages:
            self.pool.decref(pid)
        self.hit_tokens -= mr.covered
        self.lookup_tokens -= lookup_tokens
        self.lookups -= 1
        if mr.state:
            self.state_lookups -= 1
        if mr.snapshot is not None:
            self.snapshot_hits -= 1
        self.release(mr)

    def release(self, mr: MatchResult) -> None:
        """Unpin the match's node (slot closed / admission rolled back)."""
        if mr.node is not None:
            assert mr.node.pins > 0
            mr.node.pins -= 1
            mr.node = None

    def match_page(self, tokens, covered: int) -> Optional[int]:
        """Chunk-time lookup: the single full page at token offset `covered`
        (page-aligned). Lets a request adopt a page that a CONCURRENTLY
        prefilling request registered after this one was admitted — so even
        same-wave admissions of a common prefix share pages. Takes one pool
        reference on a hit."""
        ps = self._ps
        assert covered % ps == 0
        tokens = _as_tokens(tokens)
        loc = self._locate(tokens, covered)
        if loc is None:
            return None
        node, off = loc
        want = tokens[covered:covered + ps].tobytes()
        if node is not self._root and off < len(node.key):
            if node.pages is None or \
                    node.key[off:off + ps].tobytes() != want:
                return None
            pid = node.pages[off // ps]
            self._touch(node)
        else:
            child = node.children.get(want)
            if child is None or child.pages is None:
                return None
            pid = child.pages[0]
            self._touch(child)
        self.pool.incref(pid)
        self.hit_tokens += ps
        return pid

    # -- insert ------------------------------------------------------------

    def insert_pages(self, tokens, upto_page: int, page_ids: list,
                     registered: int) -> int:
        """Register full prompt pages [0, upto_page) of a request (token
        content final — chunked prefill has written their K/V); pages the
        tree already holds are skipped, the rest hang off the divergence
        point as one new node. Returns the new `registered` watermark."""
        ps = self._ps
        target = upto_page * ps
        tokens = _as_tokens(tokens)[:target]
        node, covered = self._descend(tokens, target)
        if covered < target:
            pages = None
            if self.has_pages:
                pages = [int(p) for p in page_ids[covered // ps:upto_page]]
                for pid in pages:
                    self.pool.incref(pid)
            child = _Node(tokens[covered:target].copy(), node, pages=pages)
            node.children[child.key[:ps].tobytes()] = child
            self._nodes += 1
            self._touch(child)
            self._maybe_evict_nodes()
        return max(registered, upto_page)

    def insert_partial(self, tokens, pid: int) -> bool:
        """Register the final, partially-filled prompt page (fill = len %
        page_size tokens) as a partial leaf under the node ending at the
        last full-page boundary. Unlike the chain baseline's one-per-chain
        slot, content-distinct continuations coexist — up to
        `partial_slots` per spine, LRU-displaced beyond that so the tree
        never hoards one speculative page per historical request (peak
        page usage stays BELOW the no-sharing run's). The owner COWs the
        page on its next write, freezing the cached copy at prompt-only
        content."""
        ps = self._ps
        tokens = _as_tokens(tokens)
        fill = len(tokens) % ps
        if fill == 0 or not self.has_pages:
            return False
        boundary = len(tokens) - fill
        node, covered = self._descend(tokens, boundary)
        if covered < boundary:
            return False        # full-page spine was evicted under us
        tail = tokens[boundary:]
        for pn in node.partials:
            if np.array_equal(pn.key, tail):
                return False
        while len(node.partials) >= self.partial_slots:
            live = [p for p in node.partials if p.pins == 0]
            if not live:
                return False    # every slot pinned by a live match
            self._drop_leaf(min(live, key=lambda p: p.stamp))
        pn = _Node(tail.copy(), node, pages=[int(pid)], partial=True)
        node.partials.append(pn)
        self.pool.incref(pid)
        self._nodes += 1
        self._touch(pn)
        self._maybe_evict_nodes()
        return True

    def wants_snapshot(self, tokens, boundary: int) -> bool:
        """True when no snapshot exists at this page boundary yet — the
        engine skips the device->host state extraction otherwise."""
        if boundary <= 0 or boundary % self._ps:
            return False
        loc = self._locate(_as_tokens(tokens), boundary)
        if loc is None:
            return True
        node, off = loc
        if node is self._root or off < len(node.key):
            return True         # boundary mid-node: no snapshot AT it
        return node.snapshot is None

    def insert_snapshot(self, tokens, boundary: int, blob) -> bool:
        """Attach the recurrent-state blob at token `boundary` (page
        multiple) to the node ending there, splitting a longer edge when
        needed; page-less archs grow snapshot-only nodes. First write wins
        (identical prefixes produce identical state)."""
        ps = self._ps
        assert boundary > 0 and boundary % ps == 0
        tokens = _as_tokens(tokens)[:boundary]
        node, covered = self._descend(tokens, boundary)
        if covered < boundary:
            if self.has_pages:
                return False    # page spine evicted under us: no holes
            child = _Node(tokens[covered:boundary].copy(), node, pages=None)
            node.children[child.key[:ps].tobytes()] = child
            self._nodes += 1
            self._touch(child)
            node = child
        if node.snapshot is None:
            node.snapshot = blob
            self._snaps[id(node)] = node
            self.snapshots_stored += 1
            self.snapshot_bytes += _tree_nbytes(blob)
            self._enforce_snapshot_budget()
        self._maybe_evict_nodes()
        return True

    # -- evict / spill / rehydrate ----------------------------------------

    def evictable(self) -> int:
        """Pages the cache could free under leaf-first eviction right now
        (pinned nodes and pages shared with live slots block themselves AND
        their ancestors). With no live slots this is every cached page —
        the property `_headroom` relies on for deadlock-free admission."""
        def rec(node):
            pages, all_gone = 0, True
            for ch in node.children.values():
                p, g = rec(ch)
                pages += p
                all_gone = all_gone and g
            for pn in node.partials:
                if pn.pins == 0 and self.pool.ref[pn.pages[0]] == 1:
                    pages += 1
                else:
                    all_gone = False
            if node is self._root:
                return pages, all_gone
            own = node.pages or []
            if all_gone and node.pins == 0 and \
                    all(self.pool.ref[p] == 1 for p in own):
                return pages + len(own), True
            return pages, False
        return rec(self._root)[0]

    def evict_one(self) -> bool:
        """Drop the least-recently-touched unpinned leaf (O(depth)
        amortized: the heap is lazily invalidated, blocked entries keep
        their recency). True when a node was evicted."""
        blocked = []
        evicted = False
        while self._lru:
            stamp, _, node = heapq.heappop(self._lru)
            if node.stamp != stamp or node.parent is None:
                continue                    # stale entry or detached node
            if node.children or node.partials:
                continue                    # re-pushed when it becomes a leaf
            if node.pins > 0 or (node.pages and
                                 any(self.pool.ref[p] > 1
                                     for p in node.pages)):
                blocked.append(node)        # pinned by a match or a live slot
                continue
            self._drop_leaf(node)
            evicted = True
            break
        for node in blocked:
            self._push(node)
        return evicted

    def _drop_leaf(self, node: _Node) -> None:
        if self.spill is not None and not node.partial:
            self._spill_node(node)
        if node.pages:
            for pid in node.pages:
                self.pool.decref(pid)
        parent = node.parent
        if node.partial:
            parent.partials.remove(node)
        else:
            del parent.children[node.key[:self._ps].tobytes()]
        if node.snapshot is not None:
            self._snaps.pop(id(node), None)
            self.snapshot_bytes -= _tree_nbytes(node.snapshot)
            node.snapshot = None
        node.parent = None
        node.stamp = -1
        self._nodes -= 1
        if parent is not self._root and not parent.children \
                and not parent.partials:
            self._push(parent)              # parent became an evictable leaf

    def _maybe_evict_nodes(self) -> None:
        while self._nodes > self.max_nodes:
            if not self.evict_one():
                break

    def _enforce_snapshot_budget(self) -> None:
        while len(self._snaps) > self.snapshot_budget:
            _, node = self._snaps.popitem(last=False)
            if self.spill is not None:
                self.spill.put(self._prefix_of(node), snap=node.snapshot)
                self.spills += 1
            self.snapshot_bytes -= _tree_nbytes(node.snapshot)
            node.snapshot = None            # node (and its pages) stay

    def _spill_node(self, node: _Node) -> None:
        """Write a full-page node's device rows + end-boundary snapshot into
        the spill tier, one entry per page boundary."""
        prefix = self._prefix_of(node)
        start = len(prefix) - len(node.key)
        ps = self._ps
        n_pages = len(node.key) // ps
        for i in range(n_pages):
            end = start + (i + 1) * ps
            page_blob = None
            if node.pages is not None and self._reader is not None:
                page_blob = self._reader(node.pages[i])
            snap = node.snapshot if i == n_pages - 1 else None
            if page_blob is None and snap is None:
                continue
            self.spill.put(prefix[:end], pages=page_blob, snap=snap)
            self.spills += 1

    def _rehydrate(self, node: _Node, tokens: np.ndarray,
                   covered: int) -> Optional[_Node]:
        """Re-attach one spilled page boundary as a child of `node` during a
        match walk: allocate a FREE page (no eviction cascades mid-match)
        and write the saved rows back into the device pools."""
        ps = self._ps
        key = tokens[:covered + ps]
        ent = self.spill.peek(key)
        if ent is None:
            return None
        pages = None
        if self.has_pages:
            blob = ent.get("pages")
            if blob is None or self._writer is None or \
                    self.pool.free_pages == 0:
                return None
            try:
                pid = self.pool.alloc()
            except InjectedFault:
                return None     # rehydration is opportunistic: a transient
                                # alloc fault degrades to a cache miss
            self._writer(pid, blob)
            pages = [pid]
        elif ent.get("snap") is None:
            return None
        self.spill.take(key)
        child = _Node(tokens[covered:covered + ps].copy(), node, pages=pages)
        node.children[child.key.tobytes()] = child
        snap = ent.get("snap")
        if snap is not None:
            child.snapshot = snap
            self._snaps[id(child)] = child
            self.snapshot_bytes += _tree_nbytes(snap)
        self._nodes += 1
        self._touch(child)
        self.rehydrates += 1
        self._enforce_snapshot_budget()
        return child

    def spill_all(self) -> None:
        """Write every full-page node (pages + snapshots) into the spill
        tier WITHOUT evicting — the end-of-run hook that lets the next
        `run()` (or a restarted engine via `--prefix-persist`) rehydrate
        instead of starting cold. Partial pages are dropped by design."""
        if self.spill is None:
            return
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            self._spill_node(n)

    # -- invariants (tests) ------------------------------------------------

    def check(self) -> None:
        """Structural audit: parent/child links, page ownership (each page
        owned by exactly one node, one pool ref each), page-aligned keys."""
        seen: list[int] = []
        count = 0

        def rec(node):
            nonlocal count
            if node is not self._root:
                count += 1
                assert node.parent is not None
                if node.partial:
                    assert 0 < len(node.key) < self._ps
                    assert self.has_pages and len(node.pages) == 1
                else:
                    assert len(node.key) > 0 and len(node.key) % self._ps == 0
                    if self.has_pages:
                        assert node.pages is not None and \
                            len(node.pages) == len(node.key) // self._ps
                if node.pages:
                    seen.extend(node.pages)
                    for p in node.pages:
                        assert self.pool.ref[p] >= 1, f"tree page {p} freed"
            for key, ch in node.children.items():
                assert ch.parent is node
                assert key == ch.key[:self._ps].tobytes()
                rec(ch)
            for pn in node.partials:
                assert pn.parent is node and pn.partial
                rec(pn)

        rec(self._root)
        assert count == self._nodes, (count, self._nodes)
        assert len(seen) == len(set(seen)), "page owned by two tree nodes"


class ChainPrefixCache:
    """The previous whole-chain rolling-crc32 prefix cache, kept as the
    radix tree's comparison baseline (`prefix_mode="chain"`). Same unified
    interface, but: per-page entries keyed by ``h_i = crc32(page_i tokens,
    h_{i-1})`` (commits to content AND absolute position), ONE partial
    continuation per chain, no recurrent-state snapshots (fully-paged archs
    only), no spill tier — and O(n)-scan eviction."""

    def __init__(self, pool: PagePool):
        self.pool = pool
        self.has_pages = True
        self._full: OrderedDict[int, int] = OrderedDict()       # chain -> pid
        # chain -> (pid, fill, token bytes): one partial continuation per chain
        self._partial: OrderedDict[int, tuple[int, int, bytes]] = OrderedDict()
        self.hit_tokens = 0
        self.lookup_tokens = 0
        self.lookups = 0
        self.state_lookups = 0      # always 0: no snapshots in the baseline
        self.snapshot_hits = 0
        self.snapshots_stored = 0
        self.snapshot_bytes = 0
        self.spills = 0
        self.rehydrates = 0

    def __len__(self) -> int:
        return len(self._full) + len(self._partial)

    @property
    def node_count(self) -> int:
        return len(self)

    @staticmethod
    def _page_hash(tokens: np.ndarray, prev: int) -> int:
        return zlib.crc32(_as_tokens(tokens).tobytes(), prev)

    def evictable(self) -> int:
        return sum(1 for pid in self._full.values()
                   if self.pool.ref[pid] == 1) \
            + sum(1 for pid, _, _ in self._partial.values()
                  if self.pool.ref[pid] == 1)

    def evict_one(self) -> bool:
        """Drop one unpinned entry (oldest first); True if a page was freed."""
        for table in (self._full, self._partial):
            for key, entry in table.items():
                pid = entry if isinstance(entry, int) else entry[0]
                if self.pool.ref[pid] == 1:
                    del table[key]
                    self.pool.decref(pid)
                    return True
        return False

    def match(self, tokens, max_tokens: int, *,
              need_state: bool = False) -> MatchResult:
        assert not need_state, "chain baseline has no state snapshots"
        ps = self.pool.page_size
        tokens = _as_tokens(tokens)
        self.lookup_tokens += len(tokens)
        self.lookups += 1
        pages: list[tuple[int, int]] = []
        covered, chain = 0, 0
        while covered + ps <= max_tokens:
            nxt = self._page_hash(tokens[covered:covered + ps], chain)
            pid = self._full.get(nxt)
            if pid is None:
                break
            chain = nxt
            self._full.move_to_end(chain)
            self.pool.incref(pid)
            pages.append((pid, ps))
            covered += ps
        part = self._partial.get(chain)
        matched_partial = False
        if part is not None:
            pid, fill, blob = part
            if 0 < fill <= max_tokens - covered and \
                    tokens[covered:covered + fill].tobytes() == blob:
                self._partial.move_to_end(chain)
                self.pool.incref(pid)
                pages.append((pid, fill))
                covered += fill
                matched_partial = True
        if not matched_partial and covered + ps == len(tokens) \
                and covered < max_tokens:
            # exact-page-multiple edge (see RadixPrefixCache.match)
            nxt = self._page_hash(tokens[covered:covered + ps], chain)
            pid = self._full.get(nxt)
            if pid is not None:
                self._full.move_to_end(nxt)
                self.pool.incref(pid)
                pages.append((pid, max_tokens - covered))
                covered = max_tokens
        self.hit_tokens += covered
        return MatchResult(pages=pages, covered=covered)

    def abandon(self, mr: MatchResult, lookup_tokens: int) -> None:
        for pid, _ in mr.pages:
            self.pool.decref(pid)
        self.hit_tokens -= mr.covered
        self.lookup_tokens -= lookup_tokens
        self.lookups -= 1

    def release(self, mr: MatchResult) -> None:
        pass                    # chain entries are never pinned by matches

    def match_page(self, tokens, covered: int) -> Optional[int]:
        ps = self.pool.page_size
        assert covered % ps == 0
        tokens = _as_tokens(tokens)
        chain = 0
        for i in range((covered // ps) + 1):
            chain = self._page_hash(tokens[i * ps:(i + 1) * ps], chain)
        pid = self._full.get(chain)
        if pid is None:
            return None
        self._full.move_to_end(chain)
        self.pool.incref(pid)
        self.hit_tokens += ps
        return pid

    def insert_pages(self, tokens, upto_page: int, page_ids: list,
                     registered: int) -> int:
        ps = self.pool.page_size
        tokens = _as_tokens(tokens)
        chain = 0
        for i in range(upto_page):
            chain = self._page_hash(tokens[i * ps:(i + 1) * ps], chain)
            if i < registered:
                continue
            if chain not in self._full:
                self._full[chain] = page_ids[i]
                self.pool.incref(page_ids[i])
        return max(registered, upto_page)

    def insert_partial(self, tokens, pid: int) -> bool:
        ps = self.pool.page_size
        tokens = _as_tokens(tokens)
        fill = len(tokens) % ps
        if fill == 0:
            return False
        chain = 0
        for i in range(len(tokens) // ps):
            chain = self._page_hash(tokens[i * ps:(i + 1) * ps], chain)
        if chain in self._partial:
            return False
        self._partial[chain] = (pid, fill, tokens[-fill:].tobytes())
        self.pool.incref(pid)
        return True

    def wants_snapshot(self, tokens, boundary: int) -> bool:
        return False

    def insert_snapshot(self, tokens, boundary: int, blob) -> bool:
        return False

    def spill_all(self) -> None:
        pass
