"""Spans on two clocks: the simulated network's and the host's wall clock.

The virtual-clock side is copied from ``repro.obs.trace``.  A
:class:`Span` is one structured event on the run's timeline (a protocol
phase, a crypto op, a kernel launch, a message, a dispatch decision, a
re-share, a secure-aggregation round, a churn event or a health alert).
Spans carry the virtual-clock start/duration plus, for real kernel
launches, the measured host wall time, in separate fields so determinism
pins can compare span streams with the wall clock excluded.

* :class:`Tracer` records spans in order; ``signature()`` is the
  deterministic view (wall-clock fields stripped).
* :class:`NullTracer` is the default; ``enabled`` is False and every
  method is a no-op, so call sites guard with ``if tracer.enabled:``.

The wall-clock side names the program's own steps on the clock of a
running ``torch.profiler``, so they land in the same record as the
kernels and a trace shows which step the host was in while the device
sat idle.  :func:`span` opens ``torch.profiler.record_function(name,
args)`` while a profiler records and is one shared
``contextlib.nullcontext()`` otherwise: a running profiler is the only
switch, and the program keeps no timestamps of its own.  Names come from
:data:`SPANS`, ``<layer>.<step>``; :func:`spanned` puts a whole function
in one, and :func:`begin`/:func:`end` hold one open across the runtime's
scheduler events (a phase or a round of an event-driven run).
:func:`wait` is the span of a place where the host blocks on the card;
it also counts the wait in ``obs.metrics.PROCESS`` under the span's
name, always.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Iterable

import torch

from . import metrics as obs_metrics

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


# ---------------------------------------------------------------------------
# Wall-clock spans on the profiler's clock
# ---------------------------------------------------------------------------

#: every wall-clock span the program opens, ``<layer>.<step>``
SPANS = (
    # drivers: a job's phases and rounds, and the tenant code they run
    "driver.init",          # key generation, B_k, u3 (the init phase)
    "driver.share",         # Gamma_1(u3) encrypted and stored (share phase)
    "driver.round",         # one round (a tenant-round in an engine)
    "driver.edge",          # one edge's encrypt -> step -> decrypt
    "driver.master",        # the global update of a round
    "driver.message",       # an actor handling a delivered message
    "driver.callback",      # a runtime actor's code fired by a launch
    "driver.report",        # the RunReport and ledger of a finished run
    # coalescer: the host work around each launch
    "coalescer.group",      # clustering a tick's groups across tenants
    "coalescer.pack",       # entries joined into one operand
    "coalescer.blind",      # the blinding draws of a fused encryption
    "coalescer.demux",      # results split back into each entry's form
    "coalescer.callbacks",  # the entries' callbacks fired
    # Paillier batch: Python-int work beside the limb kernels
    "paillier.exps",        # exponents as int64 (range) or Python ints
    "paillier.exps_sign",   # the exponents' sign scan, bases inverted
    "paillier.exps_phi",    # ints mod phi(p^2), phi(q^2); limb sizing
    "paillier.residues",    # bases reduced mod p^2 and q^2 on the host
    "paillier.encode",      # plaintexts as ints, (1 + m n) mod n^2
    "paillier.pack",        # ints to limbs, and limbs to the device
    "paillier.unpack",      # limbs from the device back to ints
    "paillier.decode",      # L(x) mu mod n on the host
    "paillier.blind",       # blinding units r drawn
    # model (MoE): the sigmoid router's layer (models.moe.sigmoid_block)
    "moe.route",            # scores, the top k on score + bias, weights
    "moe.dispatch",         # assignments sorted by held expert, rows
    "moe.experts",          # the held experts' grouped products
    "moe.combine",          # weighted outputs back to their tokens
    "moe.bias",             # the selection bias moved after a step
    # kernel build
    "kernels.build",        # the libraries built or loaded
    # waits: the host blocks until the card has drained its stream
    "wait.lap",             # core.protocol._PhaseClock.lap
    "wait.coalesce_clock",  # runtime.coalesce.CoalesceQueue._clock
    "wait.to_host",         # core.bigint._host: a device-to-host copy
    "wait.vec_decrypt",     # core.protocol.VecBox.decrypt's read-back
    "wait.rows_modulus",    # kernels.common.RowsModulus, index range read
    "wait.limbs",           # core.paillier_batch._limbs: pageable upload
    "wait.moe.offsets",     # models.moe.grouped: group ends read (CPU)
)
#: every wait site, each a counter of ``obs_metrics.PROCESS``: the spans of
#: :func:`wait`, then two sites too frequent for a span (tens an edge a
#: round), counted alone
WAITS = tuple(name for name in SPANS if name.startswith("wait.")) + (
    "wait.row",             # core.paillier_vec._row: pageable upload
    "wait.carry",           # core.bigint._norm: a carry test read back
)

_OFF = contextlib.nullcontext()
_recording = torch.autograd._profiler_enabled


def span(name: str, args: str | None = None):
    """``torch.profiler.record_function(name, args)`` while a profiler
    records, else the one shared null context."""
    if not _recording():
        return _OFF
    return torch.profiler.record_function(name, args)


def spanned(name: str):
    """Decorator: the function runs inside span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return run
    return wrap


def begin(name: str, args: str | None = None):
    """Open a span that a later call closes (:func:`end`), for work that
    runs across scheduler events; ``None`` with no profiler recording."""
    if not _recording():
        return None
    handle = torch.profiler.record_function(name, args)
    handle.__enter__()
    return handle


def end(handle) -> None:
    """Close a span :func:`begin` opened (``None`` is a no-op)."""
    if handle is not None:
        handle.__exit__(None, None, None)


def wait(name: str):
    """Count one wait on the card at site ``name`` (one of :data:`WAITS`)
    and return its span."""
    obs_metrics.PROCESS.count(name)
    return span(name)
