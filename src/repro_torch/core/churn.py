"""Deterministic churn schedules, copied from ``repro.core.churn``.

A :class:`ChurnSchedule` is a seeded, validated list of per-round
membership events the protocol driver consumes:

* ``leave``  — a graceful departure at the top of round ``t``: the edge's
  block is frozen (column split) or folded out of the consensus aggregate
  (row split) until it returns;
* ``rejoin`` — a full init-phase re-run: the master re-ships
  (Q_k, mu, scale), the edge rebuilds B_k and its quantized C_k, and the
  master re-encrypts Gamma_1(u3_k);
* ``fail``   — a silent crash, which only the event-driven runtime models
  (a later slice of the port); the synchronous driver rejects schedules
  that contain one.

Events apply at the top of their round, before the round's streaming
re-shares and (u1, u2) encryptions, which fixes the blinding rng order.
"""
from __future__ import annotations

import dataclasses
import random

KINDS = ("leave", "rejoin", "fail")


@dataclasses.dataclass(frozen=True)
class ChurnEvent:
    """One membership event: ``edge`` does ``kind`` at the top of ``round``."""
    round: int
    edge: int
    kind: str

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown churn kind {self.kind!r} "
                             f"(expected one of {KINDS})")
        if self.round < 1:
            raise ValueError(
                f"churn round must be >= 1 (got {self.round}): every edge "
                "participates in the init and share phases")
        if self.edge < 0:
            raise ValueError(f"negative edge index {self.edge}")


class ChurnSchedule:
    """A validated per-round event list over K edges.

    Validation replays the schedule: an edge must be present to leave or
    fail, absent to rejoin, and at least one edge must stay active after
    every round's events (the protocol needs someone to iterate with).
    Events within a round apply in list order.
    """

    def __init__(self, K: int, events):
        self.K = int(K)
        self.events = tuple(
            ev if isinstance(ev, ChurnEvent) else ChurnEvent(*ev)
            for ev in events)
        self._by_round: dict[int, list[ChurnEvent]] = {}
        for ev in self.events:
            self._by_round.setdefault(ev.round, []).append(ev)
        self._validate()

    def _validate(self) -> None:
        active = set(range(self.K))
        for t in sorted(self._by_round):
            for ev in self._by_round[t]:
                if ev.edge >= self.K:
                    raise ValueError(f"edge {ev.edge} out of range "
                                     f"(K={self.K}) at round {t}")
                if ev.kind == "rejoin":
                    if ev.edge in active:
                        raise ValueError(f"edge {ev.edge} rejoins at round "
                                         f"{t} but never left")
                    active.add(ev.edge)
                else:  # leave | fail
                    if ev.edge not in active:
                        raise ValueError(f"edge {ev.edge} {ev.kind}s at "
                                         f"round {t} but is already absent")
                    active.discard(ev.edge)
            if not active:
                raise ValueError(f"round {t} leaves no active edge")

    # -- driver interface --------------------------------------------------
    def events_at(self, t: int) -> tuple[ChurnEvent, ...]:
        return tuple(self._by_round.get(t, ()))

    @property
    def has_fails(self) -> bool:
        return any(ev.kind == "fail" for ev in self.events)

    @property
    def max_round(self) -> int:
        return max(self._by_round, default=0)

    def counts(self) -> dict:
        out = {k: 0 for k in KINDS}
        for ev in self.events:
            out[ev.kind] += 1
        return out

    def check(self, K: int, iters: int | None = None) -> "ChurnSchedule":
        """Assert the schedule fits a run's (K, iters); returns self."""
        if K != self.K:
            raise ValueError(f"schedule built for K={self.K}, run has K={K}")
        if iters is not None and self.max_round >= iters:
            raise ValueError(f"schedule has events at round "
                             f"{self.max_round} but the run stops after "
                             f"{iters} iterations")
        return self

    def __repr__(self) -> str:
        return f"ChurnSchedule(K={self.K}, events={list(self.events)!r})"

    # -- canonical constructors -------------------------------------------
    @classmethod
    def quarter(cls, K: int, iters: int, frac: float = 0.25,
                kind: str = "leave") -> "ChurnSchedule":
        """The ROADMAP scenario: ``frac`` of the edges leave (or fail) at
        one third of the run and rejoin at two thirds — deterministic, no
        seed, the same schedule in both drivers and every cipher arm."""
        n = max(1, int(round(frac * K)))
        n = min(n, K - 1)                       # someone must stay
        t_out = max(1, iters // 3)
        t_back = max(t_out + 1, (2 * iters) // 3)
        if t_back >= iters:
            raise ValueError(f"iters={iters} too short for a "
                             "leave-then-rejoin schedule (need >= 4)")
        events = [ChurnEvent(t_out, k, kind) for k in range(n)]
        events += [ChurnEvent(t_back, k, "rejoin") for k in range(n)]
        return cls(K, events)

    @classmethod
    def random(cls, K: int, iters: int, seed: int = 0,
               rate: float = 0.1, fail_frac: float = 0.0) -> "ChurnSchedule":
        """A seeded random schedule: per round each present edge departs
        with probability ``rate`` (a ``fail_frac`` share of departures are
        silent fails) and each absent edge rejoins with probability
        ``rate``.  Deterministic in ``seed``; always keeps one edge up."""
        rng = random.Random(seed ^ 0xC4B2)
        active = set(range(K))
        events: list[ChurnEvent] = []
        for t in range(1, iters):
            for k in range(K):
                if k in active:
                    if len(active) > 1 and rng.random() < rate:
                        kind = "fail" if rng.random() < fail_frac else "leave"
                        events.append(ChurnEvent(t, k, kind))
                        active.discard(k)
                elif rng.random() < rate:
                    events.append(ChurnEvent(t, k, "rejoin"))
                    active.add(k)
        return cls(K, events)
