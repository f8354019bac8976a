"""Event-driven scheduler with a virtual clock, copied from
``repro.runtime.scheduler`` (same heap order, same ``random.Random``
draws).

The runtime executes master/edge nodes as message-driven actors: every
network delivery, crypto-plane flush, and deadline timer is an event
``(time, seq, label, fn)`` on one global heap.  ``seq`` is a monotonically
increasing tie-breaker assigned at post time, so two runs that post the
same events in the same order replay *identically* — all randomness
(jitter, drops) is drawn from the scheduler-owned ``random.Random(seed)``
at post time, inside the deterministic event order.  The recorded
``trace`` replays identically across runs.

Virtual time is simulated seconds: callbacks run instantaneously at their
scheduled timestamp and may post further events (never into the past).
"""
from __future__ import annotations

import heapq
import random
from typing import Callable


class Scheduler:
    def __init__(self, seed: int = 0, trace: bool = False):
        self.now = 0.0
        self.rng = random.Random(seed)
        self._heap: list[tuple[float, int, str, Callable[[], None]]] = []
        self._seq = 0
        self.events_run = 0
        self.max_depth = 0      # peak event-queue depth (obs telemetry)
        self.trace: list[tuple[float, str]] | None = [] if trace else None

    def at(self, time: float, fn: Callable[[], None], label: str = "") -> None:
        """Post ``fn`` to run at virtual ``time`` (clamped to now)."""
        heapq.heappush(self._heap, (max(time, self.now), self._seq, label, fn))
        self._seq += 1
        if len(self._heap) > self.max_depth:
            self.max_depth = len(self._heap)

    def after(self, delay: float, fn: Callable[[], None],
              label: str = "") -> None:
        self.at(self.now + max(delay, 0.0), fn, label)

    def run(self, until: float | None = None,
            max_events: int = 10_000_000) -> None:
        """Drain the heap (or up to virtual time ``until``)."""
        while self._heap:
            t = self._heap[0][0]
            if until is not None and t > until:
                break
            t, _, label, fn = heapq.heappop(self._heap)
            self.now = t
            self.events_run += 1
            if self.events_run > max_events:
                raise RuntimeError(
                    f"scheduler exceeded {max_events} events — runaway actor?")
            if self.trace is not None:
                self.trace.append((t, label))
            fn()

    @property
    def idle(self) -> bool:
        return not self._heap
