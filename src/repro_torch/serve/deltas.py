"""Per-user compact-delta store for the serve engine (the port's copy of the
reference package's `serve/deltas.py`).

Delta lifecycle (mirrors the refcount/LRU discipline of
`repro_torch.serve.paging.PagePool`, but at user granularity):

1. **admit** — a request arrives carrying a user id. The store looks the
   user's `DeltaState` up (hit) or creates a fresh zero delta with that
   user's fixed channel selection (miss), pins it (refcount +1, one pin per
   in-flight request of that user), and the engine *materializes* it into
   the device-resident per-slot delta batch rows (zero-padded over the
   frozen layer prefix).
2. **decode gather-add** — every decode/prefill step applies the row's
   delta inside the covered matmuls
   (`repro_torch.models.common.delta_matmul_add`) in the one `paged_step`;
   the user's personalized weights never exist densely.
3. **online train** — when the user's request completes, the engine runs a
   compact train wave (`repro_torch.train.steps.make_online_wave`) over the
   request's token stream and writes the advanced delta back via `put`;
   live slots of the same user are re-materialized (a mid-stream delta
   update for their in-flight requests).
4. **evict** — `release` drops the request's pin; unpinned deltas stay
   resident (host tensors — *demoted* from the device rows, which are
   recycled) until capacity forces LRU eviction of the least-recently-used
   unpinned entry. Capacity is a hard bound: admitting a new user when
   every resident delta is pinned raises (like PagePool exhaustion) rather
   than silently growing. The store's checkpoint comes with the checkpoint
   slice (ROADMAP queue A items 11 and 13).

The store is torch-free: entries are opaque values produced by a
`make_entry(user)` factory, so the invariants are property-testable with
plain dicts.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Optional

__all__ = ["DeltaStore", "PersonalizationConfig"]


class PersonalizationConfig:
    """Knobs for per-user online personalization in the serve engine.

    sparse/optimizer default to a smoke-scale compact-update recipe; the
    optimizer must stay sgd momentum-0 (per-user state = delta only). The
    reference's `use_kernels` switch has no counterpart: the port's waves
    launch the kernels wherever the params lie on the card.
    """

    def __init__(self, sparse=None, optimizer=None, *, store_capacity=32,
                 train_tokens: int = 16, seed: int = 0):
        from repro_torch.configs.base import (OptimizerConfig,
                                              SparseUpdateConfig)
        self.sparse = sparse or SparseUpdateConfig(
            update_ratio=0.25, num_update_layers=2, channel_block=8)
        self.optimizer = optimizer or OptimizerConfig(
            kind="sgd", learning_rate=0.05)
        self.store_capacity = int(store_capacity)
        self.train_tokens = int(train_tokens)
        self.seed = int(seed)


class DeltaStore:
    """Refcounted, LRU-evicted, capacity-bounded map user -> delta entry.

    An entry is pinned while any in-flight request of that user holds it
    (one `admit` pin per request, dropped by `release`); only unpinned
    entries are evictable, strictly in least-recently-used order. The entry
    value itself is opaque (`make_entry` factory): the engine stores
    host-resident `DeltaState`s, the property tests store plain dicts.
    """

    def __init__(self, capacity: int, make_entry: Callable[[Any], Any],
                 nbytes: Optional[Callable[[Any], int]] = None):
        assert capacity >= 1
        self.capacity = capacity
        self._make = make_entry
        self._nbytes = nbytes or _default_nbytes
        self._entries: OrderedDict[Any, Any] = OrderedDict()
        self._ref: dict[Any, int] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    # -- lifecycle ----------------------------------------------------------

    def admit(self, user):
        """Look up (or create) the user's delta and pin it. Raises when the
        store is full of pinned entries (hard capacity bound)."""
        if user in self._entries:
            self.hits += 1
            self._entries.move_to_end(user)
            self._ref[user] += 1
            return self._entries[user]
        self.misses += 1
        if len(self._entries) >= self.capacity and self.evict_lru() is None:
            raise RuntimeError(
                f"delta store exhausted: {self.capacity} entries, all pinned")
        entry = self._make(user)
        self._entries[user] = entry
        self._ref[user] = 1
        return entry

    def release(self, user):
        """Drop one pin. The entry stays resident (LRU-evictable at ref 0);
        releasing below zero is a refcounting bug and raises."""
        if self._ref.get(user, 0) <= 0:
            raise RuntimeError(f"double-free of delta for user {user!r}")
        self._ref[user] -= 1

    def evict_lru(self):
        """Evict the least-recently-used UNPINNED entry; returns the evicted
        user id, or None when every resident entry is pinned."""
        for user in self._entries:
            if self._ref[user] == 0:
                del self._entries[user]
                del self._ref[user]
                self.evictions += 1
                return user
        return None

    # -- access -------------------------------------------------------------

    def get(self, user):
        """Read the user's entry (LRU-touch, no pin)."""
        self._entries.move_to_end(user)
        return self._entries[user]

    def peek(self, user):
        """Read without touching LRU order (checkpointing, tests)."""
        return self._entries[user]

    def put(self, user, entry):
        """Replace a resident user's entry (post-train-wave writeback)."""
        if user not in self._entries:
            raise KeyError(user)
        self._entries[user] = entry
        self._entries.move_to_end(user)

    def load(self, user, entry):
        """Insert an entry unpinned (the checkpoint restore path, to come);
        honors the capacity bound."""
        if user not in self._entries and len(self._entries) >= self.capacity \
                and self.evict_lru() is None:
            raise RuntimeError(
                f"delta store exhausted: {self.capacity} entries, all pinned")
        self._entries[user] = entry
        self._ref.setdefault(user, 0)
        self._entries.move_to_end(user)

    def users(self):
        """Resident user ids in LRU order (least recent first)."""
        return list(self._entries)

    def ref(self, user) -> int:
        return self._ref.get(user, 0)

    @property
    def resident_bytes(self) -> int:
        return sum(self._nbytes(e) for e in self._entries.values())

    def __len__(self):
        return len(self._entries)

    def __contains__(self, user):
        return user in self._entries

    # -- invariants ---------------------------------------------------------

    def check(self):
        assert len(self._entries) <= self.capacity, \
            f"capacity exceeded: {len(self._entries)} > {self.capacity}"
        assert set(self._entries) == set(self._ref)
        assert all(r >= 0 for r in self._ref.values())


def _default_nbytes(entry) -> int:
    return int(entry.nbytes)
