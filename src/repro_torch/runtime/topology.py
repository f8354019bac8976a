"""Edge-network topologies for the runtime simulator, copied from
``repro.runtime.topology``.

Nodes are strings: one ``master``, K ``edge{k}`` workers and (hierarchical
only) ``relay{j}`` aggregation hops.  Links are undirected; messages
follow the BFS shortest path, so a ring makes far edges pay per-hop
latency and a hierarchy funnels all edge traffic through its relay.

Adding a topology = one generator returning a :class:`Topology`; register
it in :data:`KINDS` and every entry point (edge_sim, bench_topology)
picks it up by name.
"""
from __future__ import annotations

import dataclasses
from collections import deque

MASTER = "master"
# K was capped at 64 while the gold cipher ran per-element Python pow; the
# batched CRT fast path (core/paillier_batch.py) lifted that blocker and
# bench_topology now sweeps K=128 (256 leaves headroom for mesh's O(K^2)
# links before route precomputation gets expensive).
MIN_EDGES, MAX_EDGES = 2, 256


def edge_name(k: int) -> str:
    return f"edge{k}"


@dataclasses.dataclass(frozen=True)
class Topology:
    kind: str
    nodes: tuple[str, ...]
    links: frozenset  # of frozenset({u, v})
    _routes: dict = dataclasses.field(default_factory=dict, compare=False,
                                      repr=False)

    @property
    def n_edges(self) -> int:
        return sum(1 for n in self.nodes if n.startswith("edge"))

    def neighbors(self, u: str) -> list[str]:
        out = []
        for link in self.links:
            if u in link:
                (v,) = set(link) - {u}
                out.append(v)
        return sorted(out)

    def route(self, src: str, dst: str) -> tuple[str, ...]:
        """BFS shortest path ``(src, ..., dst)``; cached per pair."""
        key = (src, dst)
        hit = self._routes.get(key)
        if hit is not None:
            return hit
        prev = {src: None}
        q = deque([src])
        while q:
            u = q.popleft()
            if u == dst:
                break
            for v in self.neighbors(u):
                if v not in prev:
                    prev[v] = u
                    q.append(v)
        if dst not in prev:
            raise ValueError(f"no route {src} -> {dst} in {self.kind}")
        path = [dst]
        while prev[path[-1]] is not None:
            path.append(prev[path[-1]])
        path = tuple(reversed(path))
        self._routes[key] = path
        return path


def _check_k(k: int) -> None:
    if not MIN_EDGES <= k <= MAX_EDGES:
        raise ValueError(f"edge count {k} outside [{MIN_EDGES}, {MAX_EDGES}]")


def _build(kind: str, nodes: list[str], pairs) -> Topology:
    return Topology(kind=kind, nodes=tuple(nodes),
                    links=frozenset(frozenset(p) for p in pairs))


def star(k: int) -> Topology:
    """Master directly linked to every edge (the paper's testbed LAN)."""
    _check_k(k)
    edges = [edge_name(i) for i in range(k)]
    return _build("star", [MASTER] + edges, [(MASTER, e) for e in edges])


def ring(k: int) -> Topology:
    """Master and edges on one cycle; traffic hops edge-to-edge."""
    _check_k(k)
    nodes = [MASTER] + [edge_name(i) for i in range(k)]
    return _build("ring", nodes,
                  [(nodes[i], nodes[(i + 1) % len(nodes)])
                   for i in range(len(nodes))])


def full_mesh(k: int) -> Topology:
    """Every node linked to every other (one hop everywhere)."""
    _check_k(k)
    nodes = [MASTER] + [edge_name(i) for i in range(k)]
    return _build("mesh", nodes,
                  [(nodes[i], nodes[j]) for i in range(len(nodes))
                   for j in range(i + 1, len(nodes))])


def hierarchical(k: int, fanout: int = 4) -> Topology:
    """master -> relay_j -> edge: relays aggregate ``fanout`` edges each."""
    _check_k(k)
    if fanout < 1:
        raise ValueError("fanout must be >= 1")
    n_relays = -(-k // fanout)
    relays = [f"relay{j}" for j in range(n_relays)]
    edges = [edge_name(i) for i in range(k)]
    pairs = [(MASTER, r) for r in relays]
    pairs += [(relays[i // fanout], edge_name(i)) for i in range(k)]
    return _build("hierarchical", [MASTER] + relays + edges, pairs)


KINDS = {"star": star, "ring": ring, "mesh": full_mesh,
         "hierarchical": hierarchical}


def make(kind: str, k: int, **kw) -> Topology:
    try:
        gen = KINDS[kind]
    except KeyError:
        raise ValueError(f"unknown topology {kind!r}; have {sorted(KINDS)}")
    return gen(k, **kw)
