"""Deterministic chaos engineering for the serve stack: seeded fault
schedules, injected failures, and simulated crashes. The port's own copy of
the reference package's `runtime/chaos.py`; in the port only the checkpoint
manager draws from it so far (``torn``), the serve engine's injection points
come with ROADMAP queue A item 13.

The paper's premise is surviving hard resource limits — skipped gradient
work, 256KB budgets — and the serve engine inherits the same discipline:
every fallible operation (page allocation, a jitted step, a stream
callback, a checkpoint write) has an *injection point* that consults a
``FaultSchedule``. The schedule is **deterministic**: the n-th draw of a
given fault kind fires iff a counter-keyed hash of ``(seed, kind, n)``
falls under that kind's rate, so the same seed always produces the same
fault sequence regardless of wall time, PYTHONHASHSEED, or platform —
chaos runs are replayable, and CI can pin "5% faults never change served
tokens" as a regression.

Fault kinds (`FaultKind`):

- ``alloc``  — ``PagePool.alloc`` raises ``InjectedFault`` (transient
  allocation failure; the engine retries the slot with backoff).
- ``step``   — a jitted prefill/decode step "fails" BEFORE executing (no
  side effects, so the retry is idempotent by construction).
- ``slow``   — the step runs but takes ``slow_s`` extra seconds (feeds
  the serve-side ``StragglerMonitor``).
- ``stream`` — the per-token stream callback raises (the engine must
  survive a broken client without wedging the slot).
- ``torn``   — a checkpoint write is torn mid-file (the manager publishes
  a truncated file; restore must detect it and fall back).

``poison_rids`` marks specific requests as *poison*: every ``step`` draw
for them fires, so retry alone can never complete them — the quarantine
path (N retries -> request closed as "quarantined", slot freed) is what
keeps one bad request from wedging a slot forever.

``kill_after`` simulates a hard crash: once ``crash_due(n_completed)``
reports True the engine raises ``InjectedCrash`` after its emergency
persist (journal is already fsynced per event), and a restarted engine
replays the request journal through the prefix spill tier.

Zero overhead when disabled: every injection point is gated on
``schedule is not None`` — an engine built without a schedule executes
exactly the pre-chaos code path.

The train-side story (SIGTERM preemption, straggler flagging, restart
loops) lives in ``runtime/fault.py``; this module is its serve-side
counterpart and reuses ``StragglerMonitor`` for per-wave serve timings.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Optional

__all__ = ["FaultKind", "FaultEvent", "FaultSchedule", "InjectedFault",
           "InjectedCrash"]


class InjectedFault(RuntimeError):
    """A transient, injected failure. Carries the fault kind; handlers
    retry (with backoff) or quarantine — never crash."""

    def __init__(self, kind: str, site: Optional[str] = None):
        super().__init__(f"injected {kind} fault"
                         + (f" at {site}" if site else ""))
        self.kind = kind
        self.site = site


class InjectedCrash(BaseException):
    """A simulated hard crash (``kill_after``). Derives from BaseException
    so ordinary ``except Exception`` recovery code cannot accidentally
    swallow it — only the crash-restart harness catches it."""


class FaultKind:
    ALLOC = "alloc"      # page-pool allocation failure
    STEP = "step"        # transient jitted-step error (pre-execution)
    SLOW = "slow"        # slow step (straggler food)
    STREAM = "stream"    # stream-callback exception
    TORN = "torn"        # torn checkpoint write
    ALL = (ALLOC, STEP, SLOW, STREAM, TORN)


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One fired fault: which kind, the per-kind draw index it fired at,
    and the caller-supplied site tag (a request id, a step label, ...)."""
    kind: str
    index: int
    site: Optional[str] = None


class FaultSchedule:
    """Seeded, deterministic fault source.

    ``draw(kind, site)`` is the single injection primitive: it advances
    the per-kind draw counter and reports whether this draw fires. The
    decision is a pure function of ``(seed, kind, counter)`` — two
    schedules with the same seed and rates produce identical fault
    sequences for identical draw sequences (pinned by a property test).

    ``rates`` maps fault kind -> probability; ``fault_rate`` is the
    shorthand that applies one rate to alloc/step/stream/slow at once.
    """

    def __init__(self, seed: int = 0, *, fault_rate: float = 0.0,
                 rates: Optional[dict] = None, slow_s: float = 0.002,
                 poison_rids: Optional[set] = None,
                 kill_after: Optional[int] = None,
                 max_faults: Optional[int] = None):
        self.seed = int(seed)
        self.rates = {k: float(fault_rate)
                      for k in (FaultKind.ALLOC, FaultKind.STEP,
                                FaultKind.STREAM, FaultKind.SLOW)}
        for k, v in (rates or {}).items():
            assert k in FaultKind.ALL, f"unknown fault kind {k!r}"
            assert 0.0 <= v <= 1.0
            self.rates[k] = float(v)
        self.slow_s = float(slow_s)
        self.poison_rids = set(poison_rids or ())
        self.kill_after = kill_after
        self.max_faults = max_faults
        self._counts: dict[str, int] = {}
        self._crashed = False
        self.events: list[FaultEvent] = []
        self.faults_injected = 0
        self.faults_by_kind: dict[str, int] = {}

    def _uniform(self, kind: str, n: int) -> float:
        """Deterministic draw in [0, 1): counter-keyed crc32, independent
        of call interleaving across kinds (each kind is its own stream)."""
        h = zlib.crc32(f"{self.seed}/{kind}/{n}".encode()) & 0xFFFFFFFF
        return h / 2.0 ** 32

    def draw(self, kind: str, site=None) -> bool:
        """Advance the `kind` stream one draw; True when the fault fires.
        Poison requests ALWAYS fire their step draws (that is what makes
        them poison — retries can never outlast them)."""
        n = self._counts.get(kind, 0)
        self._counts[kind] = n + 1
        if kind == FaultKind.STEP and site is not None \
                and site in self.poison_rids:
            fired = True
        elif self.max_faults is not None \
                and self.faults_injected >= self.max_faults:
            fired = False
        else:
            rate = self.rates.get(kind, 0.0)
            fired = rate > 0.0 and self._uniform(kind, n) < rate
        if fired:
            self.events.append(FaultEvent(kind, n, None if site is None
                                          else str(site)))
            self.faults_injected += 1
            self.faults_by_kind[kind] = self.faults_by_kind.get(kind, 0) + 1
        return fired

    def maybe_raise(self, kind: str, site=None) -> None:
        """``draw`` + raise ``InjectedFault`` when it fires — the one-liner
        for injection points that fail by exception."""
        if self.draw(kind, site):
            raise InjectedFault(kind, None if site is None else str(site))

    def crash_due(self, n_completed: int) -> bool:
        """True exactly once, when `kill_after` completions have been
        reached — the engine raises ``InjectedCrash`` at that point."""
        if self.kill_after is None or self._crashed:
            return False
        if n_completed >= self.kill_after:
            self._crashed = True
            return True
        return False

    def sequence(self) -> list[tuple[str, int, Optional[str]]]:
        """The fired-fault sequence as plain tuples (kind, index, site) —
        the comparison form for the determinism property test."""
        return [(e.kind, e.index, e.site) for e in self.events]
