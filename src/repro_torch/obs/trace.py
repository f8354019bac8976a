"""Zero-dependency span tracer, copied from ``repro.obs.trace``.

A :class:`Span` is one structured event on the run's timeline (a protocol
phase, a crypto op, a kernel launch, a message, a dispatch decision, a
re-share, a secure-aggregation round, a churn event or a health alert).
Spans carry the virtual-clock start/duration plus, for real kernel
launches, the measured host wall time, in separate fields so determinism
pins can compare span streams with the wall clock excluded.

* :class:`Tracer` records spans in order; ``signature()`` is the
  deterministic view (wall-clock fields stripped).
* :class:`NullTracer` is the default; ``enabled`` is False and every
  method is a no-op, so call sites guard with ``if tracer.enabled:``.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

#: the closed set of span categories; chrome_trace gives each its own lane
CATEGORIES = ("phase", "crypto_op", "launch", "message", "dispatch",
              "reshare", "agg", "churn", "alert", "serve")


@dataclasses.dataclass
class Span:
    """One structured trace event.

    ``t``/``dur`` are virtual-clock seconds; ``wall_ms`` is measured host
    milliseconds (kernel launches only, ``None`` elsewhere).  ``attrs``
    hold the category-specific payload (op, shape, bytes, edge,
    coalesce width, backend, ...) as JSON-safe scalars.
    """

    name: str
    cat: str
    t: float
    dur: float = 0.0
    wall_ms: float | None = None
    attrs: dict = dataclasses.field(default_factory=dict)

    def key(self) -> tuple:
        """Timing-free identity (used for counting/diffing spans)."""
        return (self.name, self.cat, tuple(sorted(self.attrs.items())))

    def as_dict(self) -> dict:
        d = {"name": self.name, "cat": self.cat,
             "t": self.t, "dur": self.dur, "attrs": dict(self.attrs)}
        if self.wall_ms is not None:
            d["wall_ms"] = self.wall_ms
        return d


class Tracer:
    """Collects :class:`Span`s in emission order."""

    enabled = True

    def __init__(self):
        self.spans: list[Span] = []

    def add(self, name: str, cat: str, t: float, dur: float = 0.0,
            wall_ms: float | None = None, **attrs) -> None:
        if cat not in CATEGORIES:
            raise ValueError(f"unknown span category {cat!r} "
                             f"(one of {CATEGORIES})")
        self.spans.append(Span(name=name, cat=cat, t=t, dur=dur,
                               wall_ms=wall_ms, attrs=attrs))

    # -- views -----------------------------------------------------------
    def signature(self) -> list[tuple]:
        """The deterministic span stream: everything except wall-clock.

        Virtual times stay in — the scheduler's clock is seeded, so two
        identical runs must agree on them — while ``wall_ms`` (host
        timing, never reproducible) is excluded.  This is the object the
        determinism tests pin equal across repeated seeded runs.
        """
        return [(s.name, s.cat, s.t, s.dur, tuple(sorted(s.attrs.items())))
                for s in self.spans]

    def as_dicts(self) -> list[dict]:
        return [s.as_dict() for s in self.spans]

    def by_cat(self, cat: str) -> list[Span]:
        return [s for s in self.spans if s.cat == cat]

    def count(self, cat: str) -> int:
        return sum(1 for s in self.spans if s.cat == cat)


class NullTracer:
    """Disabled tracer: the overhead-free default path."""

    enabled = False
    spans: tuple = ()

    def add(self, *a, **kw) -> None:
        pass

    def signature(self) -> list:
        return []

    def as_dicts(self) -> list:
        return []

    def by_cat(self, cat: str) -> list:
        return []

    def count(self, cat: str) -> int:
        return 0


#: shared no-op instance — safe to alias anywhere (it holds no state)
NULL = NullTracer()


def as_tracer(trace) -> "Tracer | NullTracer":
    """Normalize a ``trace`` knob: Tracer instance, truthy, or falsy."""
    if isinstance(trace, (Tracer, NullTracer)):
        return trace
    return Tracer() if trace else NULL


def spans_from_dicts(dicts: Iterable[dict]) -> list[Span]:
    """Rehydrate spans exported by :meth:`Tracer.as_dicts`."""
    return [Span(name=d["name"], cat=d["cat"], t=d["t"],
                 dur=d.get("dur", 0.0), wall_ms=d.get("wall_ms"),
                 attrs=dict(d.get("attrs", {})))
            for d in dicts]
