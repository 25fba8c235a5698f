"""Fault-tolerance runtime: preemption handling, straggler detection,
checkpoint-restart loops. The port's own copy of the reference package's
`runtime/fault.py` (framework-free; the port imports nothing of the
reference).

Single-controller implementations with multi-host-shaped interfaces:

- PreemptionHandler: SIGTERM (and, opt-in via include_sigint=True, SIGINT)
  -> grace flag; the train loop checks it each step and performs an
  emergency checkpoint + clean exit (maps to GKE node drain / TPU
  maintenance events). SIGINT stays opt-in so Ctrl-C keeps its normal
  KeyboardInterrupt behavior during interactive runs.
- StragglerMonitor: per-step wall-time watchdog; steps slower than
  `factor` x rolling median are flagged (at pod scale, per-host step times
  are all-gathered and the slow *host* is flagged for replacement — here
  the local step stands in for the host report).
- RestartableLoop: runs a step function under both; resumes from the latest
  checkpoint on (re)start — crash-restart is exercised in tests by killing
  and restarting the loop process.

This module covers the TRAIN loop. ``runtime/chaos.py`` holds the seeded,
deterministic fault schedule; the port's checkpoint manager draws its
``torn`` writes from it, and the serve engine its page-alloc, step, slow
and stream faults (`serve/engine.py`, which also feeds a
``StragglerMonitor`` the time of every engine iteration that ran a step).

`step_fn` is timed with the host clock: on the card it should return only
after its work is done (synchronize inside it), or the straggler monitor
times the launches.
"""
from __future__ import annotations

import collections
import signal
import statistics
import threading
import time
from typing import Callable, Optional


class PreemptionHandler:
    """Installs handlers on SIGTERM by default; pass include_sigint=True to
    also trap SIGINT (explicit opt-in — trapping Ctrl-C by default would
    swallow KeyboardInterrupt). Previous handlers are restored on exit."""

    def __init__(self, signals=(signal.SIGTERM,), *,
                 include_sigint: bool = False):
        self._flag = threading.Event()
        self._prev = {}
        sigs = tuple(signals)
        if include_sigint and signal.SIGINT not in sigs:
            sigs += (signal.SIGINT,)
        self._signals = sigs

    def __enter__(self):
        for sig in self._signals:
            self._prev[sig] = signal.signal(sig, self._handle)
        return self

    def __exit__(self, *exc):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        return False

    def _handle(self, signum, frame):
        self._flag.set()

    @property
    def preempted(self) -> bool:
        return self._flag.is_set()


class StragglerMonitor:
    """Flags steps (hosts, at scale) slower than factor x rolling median."""

    def __init__(self, factor: float = 2.5, window: int = 32,
                 warmup_steps: int = 5,
                 on_straggler: Optional[Callable[[int, float, float], None]] = None):
        self.factor = factor
        self.window = window
        self.warmup = warmup_steps
        self.on_straggler = on_straggler
        self.times = collections.deque(maxlen=window)
        self.flagged: list[tuple[int, float]] = []
        self._step = 0

    def record(self, duration: float) -> bool:
        self._step += 1
        is_straggler = False
        if len(self.times) >= self.warmup:
            med = statistics.median(self.times)
            if duration > self.factor * med:
                is_straggler = True
                self.flagged.append((self._step, duration))
                if self.on_straggler:
                    self.on_straggler(self._step, duration, med)
        self.times.append(duration)
        return is_straggler

    def median(self) -> float:
        return statistics.median(self.times) if self.times else 0.0


class RestartableLoop:
    """Checkpointed step loop: resume-from-latest, save-every-N, emergency
    save on preemption, straggler accounting."""

    def __init__(self, manager, state, total_steps: int,
                 checkpoint_every: int = 50,
                 straggler: Optional[StragglerMonitor] = None):
        self.manager = manager
        self.state = state
        self.total_steps = total_steps
        self.checkpoint_every = checkpoint_every
        self.straggler = straggler or StragglerMonitor()
        self.emergency_saved = False

    def resume(self, target=None) -> int:
        step = self.manager.latest_step()
        if step is None:
            return 0
        tree, meta = self.manager.restore(step, target=target or self.state)
        self.state = tree
        return int(meta["step"])

    def run(self, step_fn: Callable, batches, start_step: int = 0,
            on_metrics: Optional[Callable] = None) -> dict:
        with PreemptionHandler() as pre:
            step = start_step
            for batch in batches:
                if step >= self.total_steps:
                    break
                t0 = time.perf_counter()
                self.state, metrics = step_fn(self.state, batch)
                self.straggler.record(time.perf_counter() - t0)
                step += 1
                if on_metrics:
                    on_metrics(step, metrics)
                if pre.preempted:
                    self.manager.save(step, self.state,
                                      {"emergency": True,
                                       "stragglers":
                                           [[int(s), float(d)] for s, d
                                            in self.straggler.flagged],
                                       "median_step_s":
                                           float(self.straggler.median())})
                    self.emergency_saved = True
                    break
                # the final step is saved once, by the `final` save below —
                # saving it here too wrote the same step twice whenever
                # total_steps was a multiple of checkpoint_every
                if step % self.checkpoint_every == 0 \
                        and step != self.total_steps:
                    self.manager.save(step, self.state)
            if step >= self.total_steps:
                self.manager.save(step, self.state, {"final": True})
        return {"state": self.state, "step": step,
                "stragglers": list(self.straggler.flagged),
                "emergency": self.emergency_saved}
