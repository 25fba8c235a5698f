"""Paged continuous-batching serving: paging + scheduler + engine, with
per-user compact deltas and online train waves.

The engine owns a fixed number of decode *slots* and a fixed page pool.
For every window-free attention layer, a physical token-row pool
``[steps, num_pages * page_size, Hkv, D]`` is shared by ALL slots; a
per-slot page table (``[num_slots, ceil(max_len/page_size)]`` int32, -1 =
unallocated) maps logical page i to a physical page, and one page id
indexes every layer's pool. Pages are refcounted (``paging.PagePool``).

Slot life cycle::

    FREE --admit--> PREFILL --last chunk--> ACTIVE --finish/cancel--> FREE

Admission is per slot and page-gated: a request is admitted only when the
pool can cover its worst-case page need. Chunked prefill and batched decode
are the SAME ``paged_step``; inactive batch rows keep their state and their
page writes are dropped. ``requests_completed`` / ``tokens_out`` count
finished requests only; cancelled and timed-out requests land in
``requests_cancelled`` / ``tokens_cancelled``.

Per-user personalization (``deltas.DeltaStore`` + ``core/delta.py``): a
request's ``user`` routes it to a compact per-user delta, applied at decode
as a gather-add inside the step, advanced by an online compact train wave
when that user's request completes, and LRU-evicted under a hard capacity
bound. The shared base model is never written.

The reference's prefix caches (radix, chain), spill tier, request journal
and chaos machinery come with ROADMAP queue A item 13.
"""
from repro_torch.serve.deltas import DeltaStore, PersonalizationConfig
from repro_torch.serve.engine import (RequestResult, ServeEngine, ServeStats,
                                      make_random_requests)
from repro_torch.serve.paging import PagePool
from repro_torch.serve.sampling import sample_token
from repro_torch.serve.scheduler import Request, Scheduler, Slot, SlotState

__all__ = [
    "DeltaStore", "PagePool", "PersonalizationConfig", "Request",
    "RequestResult", "Scheduler", "ServeEngine", "ServeStats", "Slot",
    "SlotState", "make_random_requests", "sample_token",
]
