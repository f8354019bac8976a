"""Message transport with pluggable per-link models, copied from
``repro.runtime.transport``.

A :class:`LinkModel` prices one hop: fixed latency + serialization time
(bytes / bandwidth) + uniform jitter, with optional loss.  Dropped hops
are retransmitted after ``timeout_s`` (bytes charged again under
``link_bytes``/``retransmits``) so delivery is always eventual and the
protocol can never hang on a lossy link.

Byte accounting happens at two levels:

* ``traffic`` — one entry per *logical* end-to-end message, keyed
  ``"master->edge"`` / ``"edge->master"`` exactly like the counters in
  ``core/protocol.py`` (equal to them in sync mode);
* ``link_bytes`` — per physical hop ``(u, v)`` including relay transit
  and retransmissions, for topology benchmarks.

To add a new link model, pass ``per_link={("master","edge0"): LinkModel(...)}``
— unlisted links fall back to ``default``.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Callable

from ..obs import trace as trace_mod
from .scheduler import Scheduler
from .topology import Topology

_MAX_RETRIES = 16


@dataclasses.dataclass(frozen=True)
class LinkModel:
    bytes_per_s: float = 125e6   # 1 Gb/s LAN (paper's testbed)
    latency_s: float = 1e-3      # per-hop one-way latency
    jitter_s: float = 0.0        # uniform [0, jitter) added per hop
    drop_prob: float = 0.0       # per-hop loss probability
    timeout_s: float = 0.05      # retransmit backoff after a loss


@dataclasses.dataclass(frozen=True)
class Message:
    src: str
    dst: str
    tag: str
    payload: object
    nbytes: int


def _role(node: str) -> str:
    return "master" if node == "master" else \
        ("relay" if node.startswith("relay") else "edge")


class Transport:
    def __init__(self, sched: Scheduler, topo: Topology,
                 default: LinkModel | None = None,
                 per_link: dict | None = None,
                 tracer: "trace_mod.Tracer | trace_mod.NullTracer" = trace_mod.NULL):
        self.sched = sched
        self.topo = topo
        self.tracer = tracer
        self.default = default or LinkModel()
        self.per_link = {frozenset(k): v for k, v in (per_link or {}).items()}
        self.handlers: dict[str, Callable[[Message], None]] = {}
        self.traffic: dict[str, int] = defaultdict(int)
        self.link_bytes: dict[tuple[str, str], int] = defaultdict(int)
        self.retransmits = 0

    def bind(self, name: str, handler: Callable[[Message], None]) -> None:
        self.handlers[name] = handler

    def link_for(self, u: str, v: str) -> LinkModel:
        return self.per_link.get(frozenset((u, v)), self.default)

    def _hop_delay(self, link: LinkModel, nbytes: int,
                   hop: tuple[str, str]) -> float:
        d = link.latency_s + nbytes / link.bytes_per_s
        if link.jitter_s > 0.0:
            d += self.sched.rng.uniform(0.0, link.jitter_s)
        tries = 0
        while link.drop_prob > 0.0 and tries < _MAX_RETRIES \
                and self.sched.rng.random() < link.drop_prob:
            d += link.timeout_s
            self.link_bytes[hop] += nbytes
            self.retransmits += 1
            tries += 1
        return d

    def send(self, src: str, dst: str, tag: str, payload: object = None,
             nbytes: int = 0, extra_delay: float = 0.0) -> float:
        """Deliver ``payload`` along the routed path; returns arrival time.

        ``extra_delay`` charges sender-side work (compute, straggler
        latency) before the first hop.  Zero-byte messages are control
        acks: they ride the links but add nothing to any byte counter.
        """
        path = self.topo.route(src, dst)
        delay = max(extra_delay, 0.0)
        for u, v in zip(path, path[1:]):
            hop = (u, v)
            delay += self._hop_delay(self.link_for(u, v), nbytes, hop)
            if nbytes:
                self.link_bytes[hop] += nbytes
        if nbytes:
            self.traffic[f"{_role(src)}->{_role(dst)}"] += nbytes
        if self.tracer.enabled:
            # message span: virtual send time -> delivery (dur = modeled
            # latency + serialization + jitter + retransmit backoffs)
            self.tracer.add(tag, "message", t=self.sched.now, dur=delay,
                            src=src, dst=dst, bytes=nbytes,
                            hops=len(path) - 1)
        msg = Message(src=src, dst=dst, tag=tag, payload=payload,
                      nbytes=nbytes)
        handler = self.handlers[dst]
        self.sched.after(delay, lambda: handler(msg),
                         label=f"{tag}:{src}->{dst}")
        return self.sched.now + delay
