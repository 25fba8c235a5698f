"""Slot scheduler for continuous batching over paged caches.

The port's own copy of the reference package's `serve/scheduler.py`.
Pure-python state machine, no torch: the engine asks it which slots to
admit or chunk-prefill and reports sampled tokens back; the scheduler
decides admission, completion, and cancellation. Slot indices are batch rows of the
engine's per-slot state cache (and rows of its page-table array).

Slot life cycle::

    FREE --admit--> PREFILL --last chunk--> ACTIVE --finish/cancel--> FREE

Admission no longer runs a monolithic prefill: a PREFILL slot consumes its
prompt in page-sized chunks, one chunk per engine iteration, while ACTIVE
slots keep decoding — a long prompt never stalls in-flight requests.

Accounting: `tokens_out` / `requests_completed` are credited at FINISH
time only. A cancelled request (streaming callback returned False, or its
deadline passed) moves its tokens to `tokens_cancelled` instead — cancelled
work never inflates throughput numbers.
"""
from __future__ import annotations

import collections
import dataclasses
import enum
from typing import Callable, Optional

import numpy as np


class SlotState(enum.Enum):
    FREE = "free"
    PREFILL = "prefill"
    ACTIVE = "active"


@dataclasses.dataclass
class Request:
    """One generation request. `tokens` for token-input models, `embeds`
    ([prompt_len, d_model]) for embed-input frontends (musicgen-style; the
    port serves token inputs only so far).

    `stream` is the per-token callback ``fn(rid, token) -> bool | None``:
    called for every sampled token in order; returning False cancels the
    request mid-stream. `timeout_s` is a wall-clock budget from submission
    — a request past its deadline is cancelled (or dropped from the queue
    without ever being admitted).

    `user` routes the request to a per-user compact delta when the engine
    is built with a `PersonalizationConfig`: decode applies that user's
    delta (gather-add), and completion feeds an online train wave that
    advances it. None = plain base-model serving for this request.
    """
    rid: int
    max_new_tokens: int
    tokens: Optional[np.ndarray] = None
    embeds: Optional[np.ndarray] = None
    stream: Optional[Callable[[int, int], Optional[bool]]] = None
    timeout_s: Optional[float] = None
    user: Optional[object] = None

    @property
    def prompt_len(self) -> int:
        src = self.tokens if self.tokens is not None else self.embeds
        return int(src.shape[0])


@dataclasses.dataclass
class Slot:
    index: int
    state: SlotState = SlotState.FREE
    request: Optional[Request] = None
    # position of the next token to *consume* == tokens cached so far. A
    # freshly sampled token has NOT been cached yet: the engine advances
    # pos only after the step that consumes it (feeding the sampled token
    # at RoPE position `pos`), never at sampling time.
    pos: int = 0
    prefilled: int = 0        # prompt tokens already cached (chunked prefill)
    generated: int = 0        # tokens sampled for the current request
    last_token: int = 0       # fed to the next decode step
    out_tokens: list = dataclasses.field(default_factory=list)
    deadline: Optional[float] = None
    # engine-owned paging state for the current request
    page_ids: list = dataclasses.field(default_factory=list)
    registered_pages: int = 0  # prefix-cache registration watermark
    match: Optional[object] = None  # pinned prefix-cache MatchResult
    # engine-owned robustness state for the current request
    retries: int = 0           # transient faults absorbed so far
    retry_at: float = 0.0      # wall clock before which the slot backs off
    last_progress: float = 0.0  # watchdog: last time pos advanced


class Scheduler:
    """FIFO admission over a fixed slot set.

    The engine drives it with: `peek_admission()` / `commit_admission()`
    (two-phase, so the engine can veto on page-pool pressure),
    `prefill_slots()` for chunking, `active_slots()` for the decode mask,
    `record_token(slot, tok)` after sampling (True when the request
    completed), and `cancel(slot)` / `drop_queued(req)` for cancellation.
    """

    def __init__(self, num_slots: int, eos_id: Optional[int] = None):
        self.slots = [Slot(i) for i in range(num_slots)]
        self.queue: collections.deque[Request] = collections.deque()
        self.eos_id = eos_id
        self.requests_completed = 0
        self.requests_cancelled = 0
        self.requests_quarantined = 0
        self.tokens_out = 0
        self.tokens_cancelled = 0
        self.tokens_quarantined = 0
        self.refills = 0          # admissions into a previously-used slot

    def submit(self, request: Request) -> None:
        self.queue.append(request)

    def peek_admission(self):
        """Next (slot, request) that COULD be admitted, or None. Does not
        change any state — the engine may decline (no pages) and retry on a
        later iteration without disturbing FIFO order."""
        if not self.queue:
            return None
        for slot in self.slots:
            if slot.state is SlotState.FREE:
                return slot, self.queue[0]
        return None

    def commit_admission(self, slot: Slot, prefilled: int = 0) -> Request:
        """Bind the queue head to `slot` and start chunked prefill.
        `prefilled` > 0 when a prompt-prefix cache hit pre-populated the
        first pages (the engine set the page table accordingly)."""
        req = self.queue.popleft()
        if slot.request is not None:
            self.refills += 1
        slot.state = SlotState.PREFILL
        slot.request = req
        slot.pos = prefilled
        slot.prefilled = prefilled
        slot.generated = 0
        slot.out_tokens = []
        slot.retries = 0
        slot.retry_at = 0.0
        return req

    def prefill_slots(self) -> list[Slot]:
        return [s for s in self.slots if s.state is SlotState.PREFILL]

    def active_slots(self) -> list[Slot]:
        return [s for s in self.slots if s.state is SlotState.ACTIVE]

    def live_slots(self) -> list[Slot]:
        return [s for s in self.slots if s.state is not SlotState.FREE]

    def finish_prefill(self, slot: Slot) -> None:
        assert slot.state is SlotState.PREFILL
        assert slot.pos == slot.request.prompt_len
        slot.state = SlotState.ACTIVE

    def record_token(self, slot: Slot, token: int):
        """Account one sampled token for an ACTIVE slot; finish the request
        on max_new_tokens or EOS, cancel it if its streaming callback says
        stop. Returns "done", "cancelled", or None (still generating).
        Tokens are credited to the global counters only at completion."""
        assert slot.state is SlotState.ACTIVE
        slot.out_tokens.append(token)
        slot.last_token = token
        slot.generated += 1
        req = slot.request
        if req.stream is not None and req.stream(req.rid, token) is False:
            self.cancel(slot)
            return "cancelled"
        done = slot.generated >= req.max_new_tokens
        if self.eos_id is not None and token == self.eos_id:
            done = True
        if done:
            slot.state = SlotState.FREE
            self.requests_completed += 1
            self.tokens_out += slot.generated
            return "done"
        return None

    def cancel(self, slot: Slot) -> None:
        """Cancel a PREFILL/ACTIVE request: its tokens never count toward
        completed-request or throughput accounting."""
        assert slot.state is not SlotState.FREE
        self.requests_cancelled += 1
        self.tokens_cancelled += slot.generated
        slot.state = SlotState.FREE

    def quarantine(self, slot: Slot) -> None:
        """Close a poison request (exhausted its retry budget, or tripped
        the hung-request watchdog): the slot is freed for the next
        admission, and the request's tokens land in dedicated quarantine
        counters — never in throughput, never silently dropped."""
        assert slot.state is not SlotState.FREE
        self.requests_quarantined += 1
        self.tokens_quarantined += slot.generated
        slot.state = SlotState.FREE

    def drop_queued(self, request: Request) -> None:
        """Cancel a request still in the queue (deadline passed unadmitted)."""
        self.queue.remove(request)
        self.requests_cancelled += 1

    @property
    def done(self) -> bool:
        return not self.queue and all(
            s.state is SlotState.FREE for s in self.slots)
