"""Multi-tenant protocol serving engine with cross-tenant coalescing.

Port of ``repro.serve.protocol_engine``.  One :class:`ProtocolEngine`
admits MANY concurrent 3P-ADMM-PC2 protocol
instances — heterogeneous workload families, edge counts, key sizes and
cipher arms — and steps them all on ONE shared virtual clock.  Every
tenant's crypto ops flow through a shared
:class:`repro_torch.runtime.coalesce.CrossTenantCoalescer`, so
same-shaped Paillier launches FUSE across tenants (same op kind + same
limb width; each row names its tenant's modulus in a small table) and
the per-launch overhead amortizes across the whole fleet.  On the card the
fused launches are the per-row-modulus kernels (``mulmod_rows``,
``modexp_rows``); everything else a tenant runs goes through its own
solo path.  This is the paper's
"parallel encryption and decryption computations with long keys" pushed
one level up: not just many ciphertexts per launch, but many *protocols*
per launch.

The headline invariant is tenant isolation: each tenant's RunReport core
sections (ops, traffic, MSE trajectory, churn, reshares) are
**bit-identical** to the same config run solo through
:func:`repro_torch.runtime.runner.run_on_runtime`,
its rng consumes the same stream, and its iterate history matches to
the bit.  Fusion may only change *when* work launches, never *what* any
tenant computes or observes.

Admission policies::

    concurrent   admit every tenant at its requested time (max fusion)
    sequential   one tenant at a time, admit order (no cross-tenant work)
    auto         admit up to the tuned knee width from the dispatch
                 calibration cache; falls back to sequential (and says
                 so in stats) when no knee is cached

The knee itself comes from :func:`tune_admission` — a
``batch_size_finder``-style sweep that grows the concurrent tenant
count until aggregate rounds/sec stops improving, then persists the
knee via :func:`repro_torch.runtime.dispatch.save_serve_knee`, keyed by
the device kind of the tenants' runs (``torch-cpu`` or
``torch-cuda-<card>``).

Tenants run where their ``build_runtime`` puts them (``device=`` in
:meth:`ProtocolEngine.admit`, default ``cfg.device``, the card); one
engine's fused launches need all gold tenants on one device.
"""
from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np
import torch

from .. import resolve_device
from ..core import protocol
from ..obs import metrics as obs_metrics
from ..obs import trace as trace_mod
from ..runtime import coalesce
from ..runtime import dispatch
from ..runtime.runner import build_runtime, collect_result
from ..runtime.scheduler import Scheduler

ADMISSIONS = ("concurrent", "sequential", "auto")


@dataclasses.dataclass
class _Tenant:
    """Engine-side bookkeeping for one admitted protocol instance."""
    tid: str
    rt: object
    master: object
    wl: object
    mode: str
    cfg: "protocol.ProtocolConfig"
    admit_at: float = 0.0
    cancel_after: int | None = None
    started_at: float | None = None
    finished_at: float | None = None
    result: "protocol.ProtocolResult | None" = None

    @property
    def rounds(self) -> int:
        return len(self.master.iter_times)


class ProtocolEngine:
    """Serve many protocol instances on one clock with shared launches.

    Usage::

        eng = ProtocolEngine(admission="concurrent")
        eng.admit(A0, y0, cfg0, tid="t0")
        eng.admit(A1, y1, cfg1, tid="t1", admit_at=0.5)
        results = eng.run()          # {tid: ProtocolResult}
        eng.stats()["serve"]         # fusion + per-tenant telemetry

    ``admit`` wires each tenant through
    :func:`repro_torch.runtime.runner.build_runtime` with the engine's
    shared scheduler and a per-tenant
    :class:`~repro_torch.runtime.coalesce.TenantQueue`
    registered on the shared collector; ``run`` drains the clock and
    assembles per-tenant RunReports via
    :func:`~repro_torch.runtime.runner.collect_result` (``driver="serve"``,
    per-tenant ledger records tagged with the tenant id).
    """

    def __init__(self, *, seed: int = 0,
                 admission: str = "concurrent",
                 window: int | None = None,
                 calib_path: str | None = None,
                 trace: "bool | trace_mod.Tracer" = False,
                 tick_s: float = 1e-4):
        if admission not in ADMISSIONS:
            raise ValueError(f"admission must be one of {ADMISSIONS}, "
                             f"got {admission!r}")
        self.sched = Scheduler(seed=seed)
        self.tracer = trace_mod.as_tracer(trace)
        self.collector = coalesce.CrossTenantCoalescer(
            self.sched, tracer=self.tracer)
        self.admission = admission
        self.window = window           # explicit override for "auto"
        self.calib_path = calib_path
        self.tick_s = tick_s
        self.tenants: dict[str, _Tenant] = {}
        self._order: list[str] = []    # admit order (sequential chain)
        self._queue: list[str] = []    # not-yet-started, admit order
        self._inflight = 0
        self._window_used: int | None = None
        self._auto_fallback = False
        self._ran = False

    # -- admission --------------------------------------------------------

    def admit(self, A: np.ndarray, y: np.ndarray,
              cfg: "protocol.ProtocolConfig", *, tid: str | None = None,
              admit_at: float = 0.0, workload=None, table: dict | None = None,
              cancel_after: int | None = None, trace=None,
              **build_kwargs) -> str:
        """Register one protocol instance; returns its tenant id.

        ``admit_at`` is the earliest virtual time the tenant may start
        (staggered admission).  ``cancel_after=r`` cuts the tenant short
        after ``r`` completed rounds — its report then matches a solo run
        with ``iters=r``.  ``trace`` defaults to the engine tracer setting
        (pass a per-tenant Tracer or False to override).  Remaining
        keyword arguments forward to
        :func:`repro_torch.runtime.runner.build_runtime` (topology, link,
        mode, churn-era knobs, ``device``, ...).
        """
        if self._ran:
            raise RuntimeError("engine already ran; build a fresh one")
        tid = tid if tid is not None else f"tenant{len(self._order)}"
        if tid in self.tenants:
            raise ValueError(f"duplicate tenant id {tid!r}")
        if trace is None:
            trace = bool(self.tracer.enabled)
        rt, master, wl, mode = build_runtime(
            A, y, cfg, workload=workload, table=table,
            tick_s=build_kwargs.pop("tick_s", self.tick_s),
            sched=self.sched,
            make_queue=functools.partial(
                coalesce.TenantQueue, tenant=tid, collector=self.collector),
            trace=trace, **build_kwargs)
        for other in self.tenants.values():
            if other.rt.device != rt.device:
                raise ValueError(
                    f"tenant {tid!r} runs on {rt.device}, the engine's "
                    f"tenants on {other.rt.device}: fused launches need "
                    f"one device")
            break
        ten = _Tenant(tid=tid, rt=rt, master=master, wl=wl, mode=mode,
                      cfg=cfg, admit_at=float(admit_at),
                      cancel_after=cancel_after)
        master.cancel_after = cancel_after
        master.on_done = functools.partial(self._on_tenant_done, ten)
        self.tenants[tid] = ten
        self._order.append(tid)
        if self.tracer.enabled:
            self.tracer.add(f"serve:admit:{tid}", "serve", t=self.sched.now,
                            tenant=tid, admit_at=ten.admit_at,
                            workload=wl.name, cipher=cfg.cipher,
                            key_bits=cfg.key_bits, K=cfg.K)
        return tid

    def cancel(self, tid: str, after_round: int) -> None:
        """Cut ``tid`` short after ``after_round`` completed rounds (>=1).

        Must be called before :meth:`run` — cancellation is part of the
        deterministic schedule, so the shared-clock trace stays pinned.
        """
        if self._ran:
            raise RuntimeError("engine already ran")
        if after_round < 1:
            raise ValueError("after_round must be >= 1")
        ten = self.tenants[tid]
        ten.cancel_after = after_round
        ten.master.cancel_after = after_round
        if self.tracer.enabled:
            self.tracer.add(f"serve:cancel:{tid}", "serve", t=self.sched.now,
                            tenant=tid, after_round=after_round)

    # -- the shared-clock pump --------------------------------------------

    def _resolve_window(self) -> int:
        if self.admission == "concurrent":
            return len(self._order) or 1
        if self.admission == "sequential":
            return 1
        # auto: explicit override, then the calibration-cache knee keyed
        # by the FIRST tenant's (key_bits, nk) on its device kind
        if self.window is not None:
            return max(1, int(self.window))
        if self._order:
            first = self.tenants[self._order[0]]
            knee_w = dispatch.load_serve_knee(
                first.cfg.key_bits, first.rt.nk, path=self.calib_path,
                kind=dispatch.device_kind(first.rt.device))
            if knee_w is not None:
                return knee_w
        self._auto_fallback = True      # corrupt/absent cache: stay safe
        return 1

    def _start_tenant(self, ten: _Tenant) -> None:
        def _go():
            ten.started_at = self.sched.now
            if self.tracer.enabled:
                self.tracer.add(f"serve:start:{ten.tid}", "serve",
                                t=self.sched.now, tenant=ten.tid)
            ten.master.start()
        self.sched.at(max(self.sched.now, ten.admit_at), _go,
                      label=f"serve.start:{ten.tid}")

    def _pump(self) -> None:
        while self._queue and self._inflight < self._window_used:
            ten = self.tenants[self._queue.pop(0)]
            self._inflight += 1
            self._start_tenant(ten)

    def _on_tenant_done(self, ten: _Tenant) -> None:
        ten.finished_at = self.sched.now
        self._inflight -= 1
        if self.tracer.enabled:
            self.tracer.add(f"serve:done:{ten.tid}", "serve",
                            t=self.sched.now, tenant=ten.tid,
                            rounds=ten.rounds,
                            cancelled=ten.master.cancelled)
        self._pump()

    # -- run + reporting --------------------------------------------------

    def run(self) -> dict:
        """Drain the shared clock; returns ``{tid: ProtocolResult}``.

        Every tenant must finish (or hit its cancel cut) before the clock
        drains — anything else is a deadlock and raises.
        """
        if self._ran:
            raise RuntimeError("engine already ran; build a fresh one")
        self._ran = True
        self._window_used = self._resolve_window()
        self._queue = list(self._order)
        self._pump()
        self.sched.run()
        stuck = [t.tid for t in self.tenants.values() if not t.master.done]
        if stuck:
            raise RuntimeError(
                f"clock drained at t={self.sched.now:.4f}s with unfinished "
                f"tenants {stuck}")
        results: dict[str, protocol.ProtocolResult] = {}
        for tid in self._order:
            ten = self.tenants[tid]
            # a cancelled tenant's report must equal a solo run with
            # iters == rounds actually completed: truncate the history
            # rows the cut rounds never filled
            history = ten.master.history[:ten.rounds]
            ten.result = collect_result(
                ten.rt, ten.master, ten.wl, ten.mode, driver="serve",
                history=history, ledger_extra={"tenant": tid},
                extra_runtime={"serve": self._tenant_section(ten)})
            results[tid] = ten.result
        return results

    def _tenant_section(self, ten: _Tenant) -> dict:
        lat = []
        if ten.started_at is not None:
            times = [ten.started_at] + list(ten.master.iter_times)
            lat = [b - a for a, b in zip(times, times[1:])]
        return {
            "tenant": ten.tid,
            "admitted_at": ten.admit_at,
            "started_at": ten.started_at,
            "finished_at": ten.finished_at,
            "rounds": ten.rounds,
            "cancelled": bool(ten.master.cancelled),
            "launches": ten.rt.cq.launches,
            "coalesced_ops": ten.rt.cq.coalesced_ops,
            "round_latency_s": obs_metrics.summary(lat),
        }

    def stats(self) -> dict:
        """Engine-level report: ``{"serve": {...}}``.

        Collector fusion counters plus the admission decision and a
        per-tenant block (rounds, cancellation, p50/p95 round latency).
        """
        serve = dict(self.collector.metrics_section())
        serve.update({
            "tenants": len(self._order),
            "admission": self.admission,
            "window": self._window_used,
            "auto_fallback_sequential": self._auto_fallback,
            "virtual_time": self.sched.now,
            "per_tenant": {tid: self._tenant_section(self.tenants[tid])
                           for tid in self._order},
        })
        return {"serve": serve}


# ---------------------------------------------------------------------------
# Admission auto-tuner (lightning batch_size_finder spirit)
# ---------------------------------------------------------------------------

def knee(widths, tputs, gain_tol: float = 0.1) -> int:
    """Knee of a width -> throughput curve: the last width that still
    improved on its predecessor by more than ``gain_tol`` (relative).

    Monotone curves return the final width, plateaus stop where the
    gains die, cliffs stop before the drop.
    """
    widths, tputs = list(widths), list(tputs)
    if not widths or len(widths) != len(tputs):
        raise ValueError("widths and tputs must be equal-length, non-empty")
    i = 0
    while i + 1 < len(widths) and tputs[i + 1] > tputs[i] * (1.0 + gain_tol):
        i += 1
    return int(widths[i])


def autotune(measure, widths, gain_tol: float = 0.1):
    """Grow along ``widths`` calling ``measure(w) -> rounds/sec``; stop one
    step past the knee (no need to pay for widths that can't win).
    Returns ``(knee_width, curve_dict)``."""
    curve: dict[int, float] = {}
    prev = None
    for w in widths:
        t = float(measure(w))
        curve[int(w)] = t
        if prev is not None and t <= prev * (1.0 + gain_tol):
            break
        prev = t
    ws = sorted(curve)
    return knee(ws, [curve[w] for w in ws], gain_tol=gain_tol), curve


def tune_admission(A: np.ndarray, y: np.ndarray,
                   cfg: "protocol.ProtocolConfig", *,
                   widths=(1, 2, 4, 8, 16, 32, 64),
                   iters: int = 1, gain_tol: float = 0.1,
                   workload=None, calib_path: str | None = None,
                   persist: bool = True, device=None) -> dict:
    """Sweep concurrent tenant counts for this (workload, cfg) template and
    persist the aggregate-rounds/sec knee in the dispatch calibration
    cache (backend "serve", keyed by device kind / key_bits / nk).

    Each probe runs ``w`` clones of the template (distinct seeds) with
    ``iters`` rounds each through a concurrent engine on ``device``
    (default ``cfg.device``, the card) and measures WALL rounds/sec, the
    card synchronized at the end of each run.  Returns ``{"window",
    "curve", "key_bits", "nk"}``.
    """
    dev = resolve_device(cfg.device if device is None else device)
    probe_cfg = dataclasses.replace(cfg, iters=iters)
    nk_holder: dict = {}

    def measure(w: int) -> float:
        eng = ProtocolEngine(seed=cfg.seed, admission="concurrent")
        for i in range(w):
            tid = eng.admit(A, y, dataclasses.replace(probe_cfg, seed=i),
                            tid=f"probe{i}", workload=workload, device=dev)
            nk_holder.setdefault("nk", eng.tenants[tid].rt.nk)
        t0 = time.perf_counter()
        eng.run()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = max(time.perf_counter() - t0, 1e-9)
        return (w * iters) / wall

    # warm the kernels/caches once so width 1 isn't charged the compiles
    measure(1)
    window, curve = autotune(measure, widths, gain_tol=gain_tol)
    if persist:
        dispatch.save_serve_knee(cfg.key_bits, nk_holder.get("nk", cfg.K),
                                 window, curve=curve, path=calib_path,
                                 kind=dispatch.device_kind(dev))
    return {"window": window, "curve": curve,
            "key_bits": cfg.key_bits, "nk": nk_holder.get("nk")}
