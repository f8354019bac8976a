"""Crypto-op batching queue — one kernel launch per tick, not per edge.

Port of ``repro.runtime.coalesce``: the single-tenant queue, and below it
the serving engine's cross-tenant layer.  Actors
never call the cipher box directly: they ``submit`` ops to this queue with
a callback.  Submissions accumulate until the next tick boundary
(``tick_s`` of virtual time), then :meth:`CoalesceQueue.flush` groups them
by ``(op, element shape)`` and executes each group as ONE batched box
call:

* ``enc`` / ``add`` / ``dec`` are elementwise — K edges' vectors are
  concatenated, run through one batched call (one ``modexp_fixed`` launch
  for the round's encryptions, one for its decryptions on the gold arm),
  and split back;
* same-shaped ``matvec`` groups on the vec backend go through
  :func:`c_matvec_many`, which flattens all K ``(M, N)`` ModExp blocks
  into one ``modexp`` launch at n^2 and shares the log-tree row
  reduction; on the gold backend the same fusion runs through the
  batched CRT path (``paillier_batch.matvec_many``: one ``modexp`` launch
  per CRT half over every edge's block, limb-resident CipherTensors in
  and out).

Where the tensors live decides which kernel runs (the reference's
``backend=`` knob has no counterpart): on the card the hand-written
kernels, on the CPU their plain versions.

Because the underlying ops are exact modular arithmetic, coalescing is
bit-transparent: results and OpCounter totals are identical to issuing
each op alone.  Boxes that cannot concatenate opaque ciphertexts (the
AdaptiveBox wrapper) run per entry inside the same flush event.

``counter.phase`` is captured at submit time and restored per group at
flush time, so per-phase accounting survives the deferred execution.

``hold_ticks > 0`` relaxes the flush-every-tick rule: while every pending
group is a singleton (nothing to coalesce), the flush defers up to that
many ticks waiting for company — the moment a second same-shaped op
arrives the queue flushes at the next tick, and a hold horizon bounds the
added latency.  Late edges' ops (heterogeneous links, deadline mode) then
share a launch with their peers or with the NEXT iteration's ops.
Results stay bit-identical; only timing and launch counts change.

Launch walls (``launch_wall_ms``) are device time on a card: the box's
device is synchronized before each clock read.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from ..core import cipher_tensor as ct_mod
from ..core import paillier_batch as pbatch
from ..core import bigint as bi
from ..core import paillier_vec as pv
from ..core.cipher_tensor import CipherTensor
from ..kernels import ops
from ..obs import health as health_mod
from ..obs import metrics as obs_metrics
from ..obs import trace as trace_mod
from .scheduler import Scheduler


def c_matvec_many(vk, Ks: torch.Tensor, cs: torch.Tensor,
                  exp_limbs: int = 4) -> torch.Tensor:
    """Batched homomorphic matvec: out[b, i] = prod_j cs[b, j]^{Ks[b,i,j]}.

    ``Ks`` (B, M, N) non-negative int64, ``cs`` (B, N, L16(n^2)) limbs;
    the exponents move to the device of ``cs``.  The (B, M, N) exponent
    block becomes a single flattened ModExp launch — the coalesced form
    of ``paillier_vec.c_matvec`` — followed by one product-tree launch
    over j (``paillier_vec.mul_tree``).  The broadcast of each edge's
    vector to its M rows is a copy of B*M*N*L16*4 bytes: at K = 3 edges
    of Nk = 192 and a 2048-bit key (B*M*N = 110,592 rows of 256 limbs)
    about 113 MB.
    """
    B, M, N = Ks.shape
    L2 = vk.pack_n2.L16
    bases = cs[:, None, :, :].expand(B, M, N, L2).reshape(B * M * N, L2)
    powed = ops.modexp(bases,
                       pv.int64_to_limbs(Ks.reshape(-1).to(cs.device),
                                         exp_limbs),
                       vk.pack_n2)
    out = pv.mul_tree(vk, powed.reshape(B * M, N, L2))
    return out.reshape(B, M, L2)


@dataclasses.dataclass
class _Entry:
    args: tuple
    phase: str
    cb: Callable


def _cat(parts):
    if all(isinstance(p, CipherTensor) for p in parts):
        return ct_mod.concat(parts)        # stays limb-resident
    if isinstance(parts[0], (list, CipherTensor)):
        out = []                           # mixed reps: join as ints
        for p in parts:
            out.extend(p)
        return out
    if isinstance(parts[0], np.ndarray):
        return np.concatenate(parts)
    return torch.cat(parts)


def _split(data, sizes):
    out, i = [], 0
    for n in sizes:
        out.append(data[i:i + n])
        i += n
    return out


class CoalesceQueue:
    def __init__(self, sched: Scheduler, box, counter=None,
                 tick_s: float = 1e-4, hold_ticks: int = 0,
                 tracer: "trace_mod.Tracer | trace_mod.NullTracer" = trace_mod.NULL,
                 monitor=health_mod.NULL_MONITOR):
        self.sched = sched
        self.box = box
        self.counter = counter if counter is not None \
            else getattr(box, "counter", None)
        self.tick_s = tick_s
        self.hold_ticks = hold_ticks   # max ticks a lone op waits for company
        self.tracer = tracer
        self.monitor = monitor     # health watcher for queue-depth blowup
        self.pending: dict[tuple, list[_Entry]] = {}
        self._flush_posted = False
        self._horizon_posted = False   # a hold-horizon event is in flight
        self._win = 0                  # flush-window id (stale-event guard)
        self.launches = 0          # batched box/kernel invocations
        self.coalesced_ops = 0     # ops that shared a launch with others
        self.held_flushes = 0      # flushes deferred waiting for company
        # per-launch observability: coalesce width per launch (the
        # ops-per-launch histogram) and wall per launch split cold/warm —
        # the first launch of an (op, element-shape) group pays any kernel
        # build and load the warmup didn't cover
        self.launch_widths: list[int] = []
        self.launch_walls: dict[str, dict[str, list[float]]] = {}
        self._warm_shapes: set[tuple] = set()
        dev = getattr(box, "device", None)
        self._cuda = dev if dev is not None and dev.type == "cuda" else None

    def _clock(self) -> float:
        """Host seconds once the box's device has finished its work."""
        if self._cuda is not None:
            with trace_mod.wait("wait.coalesce_clock"):
                torch.cuda.synchronize(self._cuda)
        return time.perf_counter()

    # -- submission ------------------------------------------------------
    def submit(self, op: str, args: tuple, cb: Callable) -> None:
        """Queue ``op`` (enc/add/dec/matvec) for the next tick flush."""
        if op == "matvec":
            shape = tuple(np.asarray(args[0]).shape)
        else:
            shape = (self._size(args[0]),)
        phase = self.counter.phase if self.counter is not None else "?"
        entries = self.pending.setdefault((op, shape), [])
        entries.append(_Entry(args=args, phase=phase, cb=cb))
        if self.monitor.enabled:
            self.monitor.observe_queue_depth(
                sum(len(es) for es in self.pending.values()))
        if not self._flush_posted:
            self._flush_posted = True
            self._post_flush()
        elif self._horizon_posted and len(entries) == 2:
            # a held singleton just got company: flush at the next tick
            # (the now-stale horizon event no-ops via its window id)
            self._post_flush()

    def _post_flush(self) -> None:
        w = self._win
        self.sched.at(self._tick_time(1), lambda: self.flush(win=w),
                      label="coalesce.flush")

    def _tick_time(self, n_ticks: int) -> float:
        # n_ticks strictly after now; float division can put an exact
        # boundary a hair below its integer index, so snap before adding
        q = self.sched.now / self.tick_s
        idx = round(q) if abs(q - round(q)) < 1e-9 else int(q)
        return (idx + n_ticks) * self.tick_s

    @staticmethod
    def _size(x) -> int:
        if isinstance(x, list):
            return len(x)
        if hasattr(x, "shape"):
            return int(x.shape[0])
        return len(x)

    # -- execution -------------------------------------------------------
    def flush(self, force: bool = False, win: int | None = None) -> None:
        if win is not None and win != self._win:
            return    # event of a window that already flushed
        if not self.pending:
            return
        if (self.hold_ticks and not force
                and all(len(es) == 1 for es in self.pending.values())):
            # nothing coalesces yet — hold for company, bounded by the
            # horizon posted below
            if not self._horizon_posted:
                self._horizon_posted = True
                self.held_flushes += 1
                w = self._win
                self.sched.at(self._tick_time(self.hold_ticks),
                              lambda: self.flush(force=True, win=w),
                              label="coalesce.hold")
            return
        groups, self.pending = self.pending, {}
        self._flush_posted = False
        self._horizon_posted = False
        self._win += 1
        self._dispatch_groups(groups)
        # callbacks may have queued follow-up ops for the next tick

    def _dispatch_groups(self, groups: dict) -> None:
        """Execute one flush's groups (deterministic repr-sorted order).

        The serving engine's :class:`TenantQueue` overrides this to hand
        the groups to a shared cross-tenant collector instead."""
        for (op, shape), entries in sorted(groups.items(),
                                           key=lambda kv: repr(kv[0])):
            self._exec_group(op, shape, entries)

    def _exec_group(self, op: str, shape: tuple,
                    entries: list[_Entry]) -> None:
        """Run one (op, shape) group."""
        if self.counter is not None:
            self.counter.phase = entries[0].phase
        batchable = getattr(self.box, "name", "") in ("plain", "gold", "vec")
        # matvec truly fuses on the vec backend and on the gold box's
        # batched CRT path (other boxes loop per entry inside the group
        # runner) — keep the telemetry honest
        fused = batchable and len(entries) > 1 and \
            (op != "matvec" or self._matvec_fuses(entries))
        if not fused:
            for e in entries:
                t0 = self._clock()
                res = self._run_one(op, e.args)
                self._observe_launch(op, shape, [e],
                                     (self._clock() - t0) * 1e3,
                                     fused=False)
                self.launches += 1
                with trace_mod.span("coalescer.callbacks"):
                    e.cb(res)
            return
        self.coalesced_ops += len(entries)
        self.launches += 1
        t0 = self._clock()
        results = self._run_group(op, entries)
        self._observe_launch(op, shape, entries,
                             (self._clock() - t0) * 1e3, fused=True)
        with trace_mod.span("coalescer.callbacks"):
            for e, res in zip(entries, results):
                e.cb(res)

    def _observe_launch(self, op: str, shape: tuple, entries: list[_Entry],
                        wall_ms: float, fused: bool) -> None:
        """Record one executed launch: width, cold/warm wall, spans."""
        width = len(entries)
        self.launch_widths.append(width)
        kind = "cold" if (op, shape) not in self._warm_shapes else "warm"
        self._warm_shapes.add((op, shape))
        walls = self.launch_walls.setdefault(op, {"cold": [], "warm": []})
        walls[kind].append(wall_ms)
        if self.tracer.enabled:
            self.tracer.add(
                f"launch:{op}", "launch", t=self.sched.now, wall_ms=wall_ms,
                op=op, shape=shape, width=width, fused=fused, jit=kind,
                backend=getattr(self.box, "name", "?"),
                phase=entries[0].phase)
            for e in entries:
                self.tracer.add(op, "crypto_op", t=self.sched.now,
                                op=op, shape=shape, phase=e.phase,
                                coalesced=fused)

    def metrics_section(self) -> dict:
        """Coalescing telemetry for the RunReport ``runtime`` section."""
        return {
            "launches": self.launches,
            "coalesced_ops": self.coalesced_ops,
            "held_flushes": self.held_flushes,
            "ops_per_launch": obs_metrics.summary(self.launch_widths),
            "launch_wall_ms": {
                op: {k: obs_metrics.summary(v)
                     for k, v in walls.items() if v}
                for op, walls in sorted(self.launch_walls.items())},
        }

    def _run_one(self, op: str, args: tuple):
        if op == "enc":
            return self.box.encrypt(args[0])
        if op == "add":
            return self.box.add(args[0], args[1])
        if op == "dec":
            return self.box.decrypt(args[0])
        if op == "matvec":
            return self.box.matvec(args[0], args[1])
        raise ValueError(op)

    def _run_group(self, op: str, entries: list[_Entry]) -> list:
        if op == "matvec":
            return self._run_matvec_group(entries)
        if op not in ("enc", "add", "dec"):
            raise ValueError(op)
        with trace_mod.span("coalescer.pack"):
            if op == "enc":
                sizes = [np.asarray(e.args[0]).size for e in entries]
                args = (np.concatenate([np.asarray(e.args[0]).reshape(-1)
                                        for e in entries]),)
            else:
                sizes = [self._size(e.args[0]) for e in entries]
                args = tuple(_cat([e.args[i] for e in entries])
                             for i in range(len(entries[0].args)))
        big = self._run_one(op, args)
        with trace_mod.span("coalescer.demux"):
            return _split(big, sizes)

    def _matvec_fuses(self, entries: list[_Entry]) -> bool:
        name = getattr(self.box, "name", "")
        if name == "vec":
            return True
        if name == "gold" and getattr(self.box, "batch", False) \
                and getattr(self.box, "crt", True):
            # the fused path is the CRT decomposition; crt=False boxes
            # keep their direct per-entry reference loops
            M, N = np.asarray(entries[0].args[0]).shape
            return len(entries) * M * N >= self.box.batch_min
        return False

    def _run_matvec_group(self, entries: list[_Entry]) -> list:
        name = getattr(self.box, "name", "")
        if not self._matvec_fuses(entries):
            return [self.box.matvec(e.args[0], e.args[1]) for e in entries]
        with trace_mod.span("coalescer.pack"):
            Ks = np.stack([np.asarray(e.args[0]) for e in entries])
        B, M, N = Ks.shape
        if self.counter is not None:  # same totals box.matvec would bump
            self.counter.bump("modexp", B * M * N)
            self.counter.bump("mulmod", B * M * (N - 1))
        if name == "gold":
            # one fused batched-CRT launch over every edge's (M, N) block
            return pbatch.matvec_many(self.box.batch_key(), Ks,
                                      [e.args[1] for e in entries])
        # one fused launch for all same-shaped (M, N) blocks
        cs = torch.stack([e.args[1] for e in entries])
        out = c_matvec_many(self.box.vk,
                            torch.as_tensor(Ks.astype(np.int64)), cs)
        return [out[i] for i in range(B)]


# ---------------------------------------------------------------------------
# Cross-tenant coalescing (the serving engine's shared launch queue).
#
# Every tenant keeps its OWN TenantQueue — own box, counter, tracer — so
# solo semantics (group sort order, phase restore, telemetry) are kept;
# but instead of executing its flush locally, each queue hands its groups
# to one shared CrossTenantCoalescer.  The collector runs once per tick (a
# same-timestamp event posted during the first tenant flush — the
# scheduler's FIFO seq runs it after every tenant's flush at that tick),
# clusters groups by (op, shape, fuse_sig), and executes each cluster as
# ONE multi-key rows launch (``paillier_batch.enc_rows``/...): per-tenant
# moduli ride as a per-row table index, so tenants with DIFFERENT keys
# share the launch.
#
# Bit-transparency: the collector replays each tenant box's telemetry
# (size-based counter bumps under the entry phase) and blinding-factor
# draws (tenant rng, solo order) around the pure rows call, and demuxes
# results into exactly the representation the solo box would have
# returned (a limb-resident CipherTensor vs an int list vs an object
# ndarray, per the box's own batch/batch_min rules).  Groups with no
# fusion signature — plain, vec, adaptive boxes, non-batch gold matvec,
# negative matvec exponents — run through the tenant's own
# ``_exec_group``, i.e. literally the solo code path.
# ---------------------------------------------------------------------------

from ..core import paillier as gold  # noqa: E402  (serving layer below)

ROWS_OPS = ("enc", "dec", "add", "matvec")


def fuse_sig(box, op: str):
    """Cross-tenant fusion signature for one tenant's (box, op).

    Ops fuse across tenants iff signatures match: same op kind and same
    exact byte length of n^2 (``paillier_batch.rows_sig``).  ``None``
    means "never fuse — run the solo path"."""
    if op not in ROWS_OPS or getattr(box, "name", "") != "gold":
        return None
    key = box.key
    if not getattr(box, "crt", False) or key.g != key.n + 1:
        return None
    if op == "matvec" and not getattr(box, "batch", False):
        return None
    return pbatch.rows_sig(key)


class TenantQueue(CoalesceQueue):
    """Per-tenant CoalesceQueue that defers execution to the shared
    cross-tenant collector (solo behaviour without one)."""

    def __init__(self, *args, tenant=None, collector=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.tenant = tenant
        self.collector = collector
        if collector is not None:
            collector.register(self)

    def _dispatch_groups(self, groups: dict) -> None:
        if self.collector is None:
            super()._dispatch_groups(groups)
            return
        self.collector.collect(self, groups)


class CrossTenantCoalescer:
    """Shared launch queue: clusters all tenants' same-tick groups by
    (op, shape, fuse_sig) and executes each cluster as one launch."""

    def __init__(self, sched: Scheduler,
                 tracer: "trace_mod.Tracer | trace_mod.NullTracer" = trace_mod.NULL,
                 max_log: int = 4096):
        self.sched = sched
        self.tracer = tracer
        self.max_log = max_log
        self._pending: list[tuple] = []   # (tq, op, shape, entries)
        self._posted = False
        self.queues: list[TenantQueue] = []
        self.total_launches = 0    # every launch the collector executed
        self.rows_launches = 0     # launches through the multi-key rows path
        self.fused_launches = 0    # rows launches spanning >= 2 tenants
        self.fused_ops = 0         # ops riding those cross-tenant launches
        self.fused_log: list[dict] = []
        self.fused_log_dropped = 0

    def register(self, tq: TenantQueue) -> None:
        self.queues.append(tq)

    # -- collection ------------------------------------------------------
    def collect(self, tq: TenantQueue, groups: dict) -> None:
        # keep each tenant's solo group order (repr-sorted) so its
        # callbacks and rng draws replay in the solo sequence
        for (op, shape), entries in sorted(groups.items(),
                                           key=lambda kv: repr(kv[0])):
            self._pending.append((tq, op, shape, entries))
        if not self._posted:
            self._posted = True
            # same-timestamp event: runs after every tenant flush already
            # queued at this tick (monotonic event seq), so one cluster
            # pass sees the whole tick's ops
            self.sched.at(self.sched.now, self._execute, label="serve.fuse")

    # -- execution -------------------------------------------------------
    def _execute(self) -> None:
        self._posted = False
        pending, self._pending = self._pending, []
        with trace_mod.span("coalescer.group"):
            clusters: dict[tuple, list] = {}
            for tq, op, shape, entries in pending:
                sig = fuse_sig(tq.box, op)
                clusters.setdefault((op, shape, sig), []).append(
                    (tq, entries))
        # sorted by repr: within one tenant, (op, shape, sig) order equals
        # the solo flush's (op, shape) order — sig is a function of
        # (box, op), so two same-tenant groups never differ only in sig
        for (op, shape, sig), parts in sorted(clusters.items(),
                                              key=lambda kv: repr(kv[0])):
            with trace_mod.span("coalescer.group"):
                rows = sig is not None and self._rows_ok(op, parts)
            if not rows:
                for tq, entries in parts:
                    before = tq.launches
                    tq._exec_group(op, shape, entries)
                    self.total_launches += tq.launches - before
                continue
            self._exec_rows(op, shape, sig, parts)

    @staticmethod
    def _rows_ok(op: str, parts: list) -> bool:
        if op != "matvec":
            return True
        # a negative exponent needs the host base inversion: solo path
        return not any(bool((np.asarray(e.args[0]) < 0).any())
                       for _, entries in parts for e in entries)

    def _exec_rows(self, op: str, shape: tuple, sig: tuple,
                   parts: list) -> None:
        total = sum(len(es) for _, es in parts)
        dev = parts[0][0].box.device
        t0 = parts[0][0]._clock()
        with trace_mod.span("coalescer.pack"):
            if op == "enc":
                flats = [[int(v) for e in entries
                          for v in np.asarray(e.args[0]).reshape(-1)]
                         for _, entries in parts]
            elif op == "matvec":
                items = [(tq.box.key, np.stack([np.asarray(e.args[0])
                                                for e in entries]),
                          [e.args[1] for e in entries])
                         for tq, entries in parts]
            else:   # dec, add: each tenant's operands joined
                items = [(tq.box.key,
                          *(_cat([e.args[i] for e in entries])
                            for i in range(len(entries[0].args))))
                         for tq, entries in parts]
        if op == "enc":
            with trace_mod.span("coalescer.blind"):
                # blinding draws: each tenant's own rng, solo (entry) order
                items = [(box.key, flat,
                          [gold.rand_r(box.key, box.rng) for _ in flat])
                         for box, flat in zip((tq.box for tq, _ in parts),
                                              flats)]
        rows_op = {"enc": pbatch.enc_rows, "dec": pbatch.dec_rows,
                   "add": pbatch.add_rows, "matvec": pbatch.matvec_rows}
        outs = rows_op[op](items, device=dev)
        wall_ms = (parts[0][0]._clock() - t0) * 1e3
        for (tq, entries), out in zip(parts, outs):
            self._demux(tq, op, shape, entries, out, wall_ms, total)
        self.total_launches += 1
        self.rows_launches += 1
        if len(parts) > 1:
            self.fused_launches += 1
            self.fused_ops += total
        if len(self.fused_log) < self.max_log:
            self.fused_log.append({
                "op": op, "shape": tuple(shape), "limb_bytes": sig[1],
                "tenants": [tq.tenant for tq, _ in parts],
                "widths": [len(es) for _, es in parts]})
        else:
            self.fused_log_dropped += 1
        if self.tracer.enabled:
            self.tracer.add(f"serve:launch:{op}", "serve", t=self.sched.now,
                            wall_ms=wall_ms, op=op, shape=shape, width=total,
                            tenants=len(parts), limb_bytes=sig[1])

    def _demux(self, tq: TenantQueue, op: str, shape: tuple,
               entries: list[_Entry], out, wall_ms: float,
               total: int) -> None:
        """Rebuild exactly the representation + telemetry the tenant's
        solo box call would have produced, then fire the callbacks."""
        results = self._results(tq, op, shape, entries, out)
        tq.launches += 1
        if total > 1:
            tq.coalesced_ops += len(entries)
        tq._observe_launch(op, shape, entries, wall_ms,
                           fused=total > 1 or len(entries) > 1)
        with trace_mod.span("coalescer.callbacks"):
            for e, res in zip(entries, results):
                e.cb(res)

    @staticmethod
    @trace_mod.spanned("coalescer.demux")
    def _results(tq: TenantQueue, op: str, shape: tuple,
                 entries: list[_Entry], out) -> list:
        """Each entry's result in the tenant's solo representation, with
        the counter bumps the solo box call makes."""
        box = tq.box

        def cipher(limbs: torch.Tensor, resident: bool):
            # the solo box's representation: a resident CipherTensor on
            # its batched path, Python ints on its scalar loops
            if resident:
                return CipherTensor(box.batch_key(), limbs)
            return bi.to_ints(limbs)

        if tq.counter is not None:
            tq.counter.phase = entries[0].phase
        if op == "enc":
            sizes = [int(np.asarray(e.args[0]).size) for e in entries]
            if tq.counter is not None:
                tq.counter.bump("enc", len(out))
            big = cipher(out, box.batch and len(out) >= box.batch_min)
            results = _split(big, sizes)
        elif op == "dec":
            sizes = [CoalesceQueue._size(e.args[0]) for e in entries]
            if tq.counter is not None:
                tq.counter.bump("dec", len(out))
            results = _split(np.array(out, dtype=object), sizes)
        elif op == "add":
            sizes = [CoalesceQueue._size(e.args[0]) for e in entries]
            if tq.counter is not None:
                tq.counter.bump("mulmod", len(out))
            all_ct = all(isinstance(e.args[0], CipherTensor)
                         and isinstance(e.args[1], CipherTensor)
                         for e in entries)
            results = _split(cipher(out, box.batch and all_ct), sizes)
        else:   # matvec — mirror _matvec_fuses + box.matvec rep rules
            M, N = shape
            E = len(entries)
            if tq.counter is not None:
                tq.counter.bump("modexp", E * M * N)
                tq.counter.bump("mulmod", E * M * (N - 1))
            if E * M * N >= box.batch_min:
                ct_in = all(isinstance(e.args[1], CipherTensor)
                            for e in entries)
                results = [cipher(rows, ct_in) for rows in out]
            else:
                results = [cipher(rows, M * N >= box.batch_min
                                  and isinstance(e.args[1], CipherTensor))
                           for e, rows in zip(entries, out)]
        return results

    def metrics_section(self) -> dict:
        """Engine-level fusion telemetry (stats["serve"] feed)."""
        return {"launches": self.total_launches,
                "rows_launches": self.rows_launches,
                "fused_launches": self.fused_launches,
                "fused_ops": self.fused_ops,
                "fused_log_dropped": self.fused_log_dropped}
