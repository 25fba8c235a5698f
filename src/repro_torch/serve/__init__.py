"""Paged continuous-batching serving: paging + scheduler + engine, with
per-user compact deltas and online train waves.

The engine owns a fixed number of decode *slots* and a fixed page pool.
Sliding-window layers keep per-slot ring buffers and mamba / rwkv layers
per-slot recurrent state; for every window-free attention layer, a
physical token-row pool
``[steps, num_pages * page_size, Hkv, D]`` is shared by ALL slots; a
per-slot page table (``[num_slots, ceil(max_len/page_size)]`` int32, -1 =
unallocated) maps logical page i to a physical page, and one page id
indexes every layer's pool. Pages are refcounted (``paging.PagePool``).

Slot life cycle::

    FREE --admit--> PREFILL --last chunk--> ACTIVE --finish/cancel--> FREE

Admission is per slot and page-gated: a request is admitted only when the
pool (free pages plus the prefix cache's evictable ones) can cover its
worst-case page need (an arch with no window-free attention layer, rwkv,
uses no pages). Chunked prefill and batched decode
are the SAME ``paged_step``; inactive batch rows keep their state and their
page writes are dropped. ``requests_completed`` / ``tokens_out`` count
finished requests only; cancelled and timed-out requests land in
``requests_cancelled`` / ``tokens_cancelled``.

Per-user personalization (``deltas.DeltaStore`` + ``core/delta.py``): a
request's ``user`` routes it to a compact per-user delta, applied at decode
as a gather-add inside the step, advanced by an online compact train wave
when that user's request completes, and LRU-evicted under a hard capacity
bound. The shared base model is never written.

Prefix reuse (``paging.RadixPrefixCache``, the default; the
``ChainPrefixCache`` baseline): prompts share refcounted pages
copy-on-write, ring and recurrent-state families restore a snapshot at the
deepest shared page boundary, and evicted prefixes spill to a host
``SpillTier`` that outlives a run and, with ``prefix_persist``, a restart.

Robustness (``runtime/chaos.py``): a seeded ``FaultSchedule`` fails page
allocations, steps and stream callbacks on a replayable schedule, always
before any launch or pool mutation, so faults delay requests but never
change their tokens; a faulted slot retries with capped backoff, a poison
or hung request is quarantined, admission sheds load under a free-page
watermark, and the ``RequestJournal`` (``journal.py``) lets a restarted
engine replay the requests a crash left in flight.
"""
from repro_torch.serve.deltas import DeltaStore, PersonalizationConfig
from repro_torch.serve.engine import (RequestResult, ServeEngine, ServeStats,
                                      make_branching_prefix_requests,
                                      make_random_requests,
                                      make_shared_prefix_requests)
from repro_torch.serve.journal import RequestJournal
from repro_torch.serve.paging import (ChainPrefixCache, MatchResult,
                                      PagePool, RadixPrefixCache, SpillTier)
from repro_torch.serve.sampling import sample_token
from repro_torch.serve.scheduler import Request, Scheduler, Slot, SlotState

__all__ = [
    "ChainPrefixCache", "DeltaStore", "MatchResult", "PagePool",
    "PersonalizationConfig", "RadixPrefixCache", "Request", "RequestJournal",
    "RequestResult",
    "Scheduler", "ServeEngine", "ServeStats", "Slot", "SlotState",
    "SpillTier", "make_branching_prefix_requests", "make_random_requests",
    "make_shared_prefix_requests", "sample_token",
]
