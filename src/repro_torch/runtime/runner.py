"""3P-ADMM-PC2 as actor programs on the edge-network runtime.

Port of ``repro.runtime.runner``.  The big-integer work of every actor
(the cipher box, secure aggregation, the collaborative edges) runs on
``device`` (default the card, ``"cuda"`` without one raises); the
scheduler, transport and plaintext float64 math stay on the host.

The three protocol phases of ``core/protocol.py`` become message-driven
state machines: a :class:`MasterActor` drives init -> share -> iterate,
K :class:`EdgeActor`s evaluate eq. (13) on ciphertexts, and every crypto
op funnels through the :class:`~repro_torch.runtime.coalesce.CoalesceQueue`
(same-tick ops from different edges share one kernel launch).

Modes
-----
* ``sync``     — the master barriers on all K replies per iteration.
  Bit-for-bit identical to ``protocol.run_protocol``: same
  quantization, same Jacobi update order, same per-message byte
  accounting; it also equals the reference's runtime in the
  deterministic ``stats["runtime"]`` keys.
* ``deadline`` — the master arms a per-iteration timer at ``cfg.deadline``
  virtual seconds; replies missing when it fires are replaced by the
  stale cached block *paired with the w-sum of the round that produced
  it* (the Theorem-1 correction must match the ciphertext chain inputs).
  An edge that has never replied — or whose cached block is more than
  ``stale_limit`` rounds old (SSP-style bounded staleness; late replies
  refresh the cache as they trickle in) — is waited for instead, so even
  a deadline shorter than the physical round-trip degrades into periodic
  barriers rather than frozen blocks.  This subsumes the old inline
  straggler hack in ``run_protocol``, which now delegates here.

Per-edge response latency comes from ``cfg.latency_fn`` when given
(reproducing the legacy knob), else from the :class:`CostModel` estimate
of the edge's homomorphic step.

Streaming workloads (``Workload.streaming``) re-run the share phase
mid-run: at the top of each round the master asks the workload which
edges' u3 changed, encrypts the fresh Gamma_1 vectors through the SAME
coalescing queue as the round's (u1, u2) pairs — so re-shares fuse into
the round's enc launch, zero extra kernel launches — and ships them as
round-tagged ``"reshare"`` messages (stored edge-side without the share
barrier's reply; the tag drops an older re-share that jitter or a
retransmit delivers after a newer one).  Scheduler FIFO at equal
timestamps keeps a re-share ahead of its round's ``"step"`` on the same
link; under jitter a step may overtake it, in which case that edge's
round runs on the previous segment's u3 — bounded staleness, never
corruption.

Churn (``cfg.churn``, a :class:`~repro_torch.core.churn.ChurnSchedule`)
applies at the top of each round, before the round's re-shares and
(u1, u2) encryptions: a ``leave`` freezes/folds the departing block
exactly as ``run_protocol`` does; a ``rejoin`` re-runs the full init
phase for that edge (Q_k shipped as a round-tagged ``"reinit"``, B_k
rebuilt edge-side, Gamma_1(u3) re-encrypted through the round's
coalesced enc launch — the re-share contract generalized from u3-only
to C_k/Q_k); a ``fail`` is pure fault injection — the edge actor stops
replying and the master is NOT told.  Detection rides the deadline
machinery: stale cached blocks substitute while they last, then the
master probes every ``cfg.deadline``; after ``fail_detect`` silent
probes the edge is declared dead and folded out like a departure (so
fail schedules require ``mode="deadline"``).  Recycled updates
(``cfg.recycle``, Zhang et al. arXiv:1910.04581): an edge whose
quantized (u1, u2) moved by at most ``cfg.recycle_tol`` since its last
fresh round reuses the cached decrypted chain — no enc, no launch, no
dec, no traffic — priced as a ``recycled`` op and a ``churn:recycle``
span; at the default tolerance 0 the trajectory is bit-identical.
"""
from __future__ import annotations

import math
import random
from functools import partial

import numpy as np

from .. import resolve_device
from ..analysis import roofline
from ..core import paillier as gold
from ..core import protocol
from ..core.quantization import (gamma1, gamma2, gamma1_saturation,
                                 gamma2_saturation, dequantize_theorem1)
from ..kernels import compile_cache
from ..obs import health as health_mod
from ..obs import ledger as ledger_mod
from ..obs import metrics as obs_metrics
from ..obs import trace as trace_mod
from . import dispatch
from .coalesce import CoalesceQueue
from .scheduler import Scheduler
from .topology import MASTER, Topology, edge_name, star
from .transport import LinkModel, Message, Transport


class EdgeActor:
    """Wraps a ``protocol.EdgeNode``; owns only Remark-4-visible state."""

    def __init__(self, k: int, rt: "_Runtime"):
        self.k = k
        self.name = edge_name(k)
        self.rt = rt
        self.node = protocol.EdgeNode(k, rt.cfg.spec)
        self._share_round = -1   # newest re-share round stored so far
        self.alive = True        # fault-injection switch (churn "fail")

    @trace_mod.spanned("driver.message")
    def on_message(self, msg: Message) -> None:
        rt = self.rt
        if not self.alive:
            # crashed silently: inbound messages vanish, nothing replies.
            # The master finds out only through its deadline machinery.
            return
        if msg.tag == "init":
            Qk, mu, scale = msg.payload
            Bk = self.node.init_phase(Qk, mu, scale)
            rt.transport.send(self.name, MASTER, "init_ok", (self.k, Bk),
                              nbytes=Bk.nbytes)
        elif msg.tag == "reinit":
            # churn rejoin: the full init-phase re-run.  The edge rebuilds
            # B_k / Gamma_2(C_k); the reply carries no content the master
            # needs (it re-derived B_k itself to keep enc ordering) but
            # prices the handback at B_k's width, matching run_protocol.
            Qk, mu, scale = msg.payload
            Bk = self.node.init_phase(Qk, mu, scale)
            rt.transport.send(self.name, MASTER, "reinit_ok", self.k,
                              nbytes=Bk.nbytes)
        elif msg.tag == "collab":
            self.node.collab_setup(*msg.payload)
        elif msg.tag == "share":
            self.node.store_shared(msg.payload)
            rt.transport.send(self.name, MASTER, "share_ok", self.k)
        elif msg.tag == "reshare":
            # streaming workloads: a mid-run u3 refresh — store and go,
            # no barrier reply (the master never waits on re-shares).
            # Round-tagged: jitter/retransmits can reorder deliveries,
            # and an older segment's u3 must never overwrite a newer one
            # (the initial share always lands first — the share phase
            # barriers on share_ok before any reshare is sent).
            t, c_alpha = msg.payload
            if t > self._share_round:
                self._share_round = t
                self.node.store_shared(c_alpha)
        elif msg.tag == "step":
            t, cz, cv = msg.payload
            # eq. (13) chain; each op coalesces with the other edges' ops
            rt.cq.submit("add", (cz, cv),
                         lambda s: rt.cq.submit(
                             "matvec", (self.node.Gb, s),
                             lambda tv: rt.cq.submit(
                                 "add", (self.node.alpha_hat, tv),
                                 partial(self._reply, t))))
        else:
            raise ValueError(f"edge got unexpected tag {msg.tag!r}")

    @trace_mod.spanned("driver.callback")
    def _reply(self, t: int, x_hat) -> None:
        rt, cfg = self.rt, self.rt.cfg
        if cfg.latency_fn is not None:
            extra = cfg.latency_fn(self.k, t)
        else:
            extra = rt.cost.edge_step_cost(rt.nk)
        if cfg.collaborative and rt.key is not None and cfg.cipher == "gold":
            # decryption assist: (x-hat)' = x-hat mod p^2 rides back too
            self.node.reduce_p2(x_hat)
            rt.transport.send(
                self.name, MASTER, "assist", None,
                nbytes=(rt.key.p2.bit_length() + 7) // 8 * rt.nk,
                extra_delay=extra)
        rt.transport.send(self.name, MASTER, "xhat", (self.k, t, x_hat),
                          nbytes=rt.box.ct_bytes(rt.nk), extra_delay=extra)


class MasterActor:
    def __init__(self, rt: "_Runtime", A: np.ndarray, y: np.ndarray,
                 wl: "protocol.workloads_mod.Workload"):
        self.rt = rt
        cfg = rt.cfg
        K, Nk = cfg.K, rt.nk
        ys = y / K if cfg.y_scale == "consistent" else y
        self.wl = wl
        self.wst = wl.init_state(A, y, ys, K,   # workload iteration state
                                 y_scale=cfg.y_scale)
        self.agg_ctx = None
        if wl.uses_secure_agg:
            # row-split consensus: z-update aggregate through secure
            # aggregation (bit-exact plaintext mirror on the plain arm);
            # shares the protocol OpCounter, and its bytes are folded
            # into the traffic stats at teardown (parity with
            # run_protocol's accounting)
            self.agg_ctx = protocol.workloads_mod.SecureAggContext.for_run(
                cfg.spec, rt.key, cfg.seed, rt.counter, rt.box.ct_bytes(1),
                device=rt.device)
            self.wst.aux["secure_agg"] = self.agg_ctx
        self.edge_setups = [wl.edge_setup(self.wst, k) for k in range(K)]
        self.C_rowsums: list = [None] * K
        self.Bks: list = [None] * K   # kept for streaming u3 refreshes
        self.u3s: list = [None] * K
        self._n_init = 0
        self._n_share = 0
        self.reshare_events = 0
        # iterate-phase bookkeeping (mirrors run_protocol's master frame;
        # the (x, z, v) triple itself lives in the workload state)
        N = K * rt.nk                 # stacked master iterate (wl.dims)
        self.history = np.zeros((cfg.iters, N))
        self.x_hat_cache: list = [None] * K   # (x_hat, w_sum, round)
        self._w_rounds: dict[int, dict[int, float]] = {}
        self._cts_rounds: dict[int, dict[int, dict]] = {}
        self.stale_events = 0
        self.iter_times: list[float] = []
        self.t = -1
        self.done = False
        # serving hooks: the engine chains admissions on completion and
        # may cut a tenant short after a given number of completed rounds
        self.on_done: "Callable | None" = None
        self.cancel_after: int | None = None
        self.cancelled = False
        # churn + recycled-update state (mirrors run_protocol's frame)
        self.churn = cfg.churn
        self.active = set(range(K))
        self.churn_counts = {"leaves": 0, "rejoins": 0, "fails": 0,
                             "deaths": 0}
        self.recycled = 0
        if self.churn is not None:
            self.wst.aux["churn_active"] = np.ones(K, dtype=bool)
        self.last_q: list = [None] * K   # last encrypted (qz, qv) pair
        self.last_R: list = [None] * K   # its decrypted integer chain
        self._q_rounds: dict[int, dict[int, tuple]] = {}
        # the open wall-clock span of the phase or round (obs.trace.begin)
        self._span = None

    # -- Initialization phase -------------------------------------------
    def start(self) -> None:
        rt, cfg = self.rt, self.rt.cfg
        rt.counter.phase = protocol.PHASE_INIT
        self._phase_t0 = rt.sched.now
        if cfg.iters == 0:
            self.done = True
            if self.on_done is not None:
                self.on_done()
            return
        self._span = trace_mod.begin("driver.init", self._span_args())
        for k in range(cfg.K):
            if cfg.collaborative and rt.key is not None:
                rt.transport.send(MASTER, edge_name(k), "collab",
                                  (rt.key.p2, rt.key.phi_p2, rt.key.g,
                                   cfg.gold_batch, rt.device))
            Qk, mu, scale = self.edge_setups[k]
            rt.transport.send(MASTER, edge_name(k), "init",
                              (Qk, mu, scale), nbytes=Qk.nbytes)

    @trace_mod.spanned("driver.message")
    def on_message(self, msg: Message) -> None:
        if msg.tag == "init_ok":
            k, Bk = msg.payload
            scale = self.edge_setups[k][2]
            self.C_rowsums[k] = (Bk * scale) @ np.ones(self.rt.nk)
            self.Bks[k] = Bk
            self.u3s[k] = self.wl.share_vector(self.wst, k, Bk)
            self._n_init += 1
            if self._n_init == self.rt.cfg.K:
                self._share()
        elif msg.tag == "share_ok":
            self._n_share += 1
            if self._n_share == self.rt.cfg.K:
                rt = self.rt
                rt.clock.lap(protocol.PHASE_SHARE)
                trace_mod.end(self._span)
                if rt.tracer.enabled:
                    rt.tracer.add("phase:share", "phase", t=self._phase_t0,
                                  dur=rt.sched.now - self._phase_t0)
                self._phase_t0 = rt.sched.now
                rt.counter.phase = protocol.PHASE_ITERATE
                self._iterate(0)
        elif msg.tag == "xhat":
            self._on_xhat(*msg.payload)
        elif msg.tag in ("assist", "reinit_ok"):
            pass  # byte accounting only; content unused by the simulation
        else:
            raise ValueError(f"master got unexpected tag {msg.tag!r}")

    # -- Data security sharing phase -------------------------------------
    def _share(self) -> None:
        rt = self.rt
        rt.clock.lap(protocol.PHASE_INIT)
        trace_mod.end(self._span)
        self._span = trace_mod.begin("driver.share", self._span_args())
        if rt.tracer.enabled:
            rt.tracer.add("phase:init", "phase", t=self._phase_t0,
                          dur=rt.sched.now - self._phase_t0)
        self._phase_t0 = rt.sched.now
        rt.counter.phase = protocol.PHASE_SHARE
        for k in range(rt.cfg.K):
            q_alpha = np.asarray(gamma1(self.u3s[k], rt.cfg.spec))
            if rt.monitor.enabled:
                rt.monitor.observe_quant(
                    -1, *gamma1_saturation(q_alpha, rt.cfg.spec))
            rt.cq.submit("enc", (q_alpha,), partial(self._share_ready, k))

    def _share_ready(self, k: int, c_alpha) -> None:
        rt = self.rt
        rt.transport.send(MASTER, edge_name(k), "share", c_alpha,
                          nbytes=rt.box.ct_bytes(rt.nk))

    def _reshare_ready(self, k: int, t: int, c_alpha) -> None:
        rt = self.rt
        rt.transport.send(MASTER, edge_name(k), "reshare", (t, c_alpha),
                          nbytes=rt.box.ct_bytes(rt.nk))

    # -- Parallel privacy-computing phase ---------------------------------
    def _apply_churn(self, t: int) -> None:
        """Apply the schedule's round-``t`` events (top of round, before
        the streaming re-shares — the order run_protocol fixes)."""
        rt, cfg = self.rt, self.rt.cfg
        for ev in self.churn.events_at(t):
            k = ev.edge
            self.last_q[k] = self.last_R[k] = None
            if rt.tracer.enabled:
                rt.tracer.add(f"churn:{ev.kind}", "churn", t=rt.sched.now,
                              edge=k, round=t)
            if ev.kind == "leave":
                # graceful handoff: the master already holds the block
                # (it decrypts every round), so departure is zero-traffic
                # — the block freezes / folds out via churn_active
                self.active.discard(k)
                self.wst.aux["churn_active"][k] = False
                self.x_hat_cache[k] = None
                self.churn_counts["leaves"] += 1
            elif ev.kind == "fail":
                # fault INJECTION, not protocol logic: the harness flips
                # the actor's crash switch; the master learns nothing
                # here — detection is the deadline + probe machinery's
                # job (see _on_deadline/_probe)
                rt.edge_actors[k].alive = False
                self.churn_counts["fails"] += 1
            else:  # rejoin — FULL init-phase re-run (PR-5 reshare
                # contract generalized from u3-only to C_k/Q_k)
                self.active.add(k)
                self.wst.aux["churn_active"][k] = True
                self.x_hat_cache[k] = None
                rt.edge_actors[k].alive = True
                self.churn_counts["rejoins"] += 1
                Qk, mu, scale = self.wl.edge_setup(self.wst, k)
                self.edge_setups[k] = (Qk, mu, scale)
                rt.transport.send(MASTER, edge_name(k), "reinit",
                                  (Qk, mu, scale), nbytes=Qk.nbytes)
                # the master re-derives B_k itself (the identical inverse
                # the edge computes on "reinit") instead of barriering on
                # reinit_ok: this round's enc submissions must keep
                # run_protocol's order — rejoin u3 first, then streaming
                # re-shares, then the z/v pairs — for blinding-rng parity
                Bk = np.linalg.inv(Qk + mu * np.eye(rt.nk))
                sc = mu if scale is None else scale
                self.C_rowsums[k] = (Bk * sc) @ np.ones(rt.nk)
                self.Bks[k] = Bk
                self.u3s[k] = self.wl.share_vector(self.wst, k, Bk)
                q_alpha = np.asarray(gamma1(self.u3s[k], cfg.spec))
                rt.cq.submit("enc", (q_alpha,),
                             partial(self._reshare_ready, k, t))

    def _span_args(self, t: int | None = None) -> str:
        """A wall-clock span's args: the tenant (in an engine) and round."""
        tenant = getattr(self.rt.cq, "tenant", None)
        args = [] if tenant is None else [f"tenant={tenant}"]
        if t is not None:
            args.append(f"round={t}")
        return ",".join(args)

    def _iterate(self, t: int) -> None:
        rt, cfg = self.rt, self.rt.cfg
        self._span = trace_mod.begin("driver.round", self._span_args(t))
        self.t = t
        self.iter_start = rt.sched.now
        self.replies: dict[int, object] = {}
        self.w_cur: dict[int, float] = {}
        self.finalized = False
        self.deadline_passed = False
        self.must_wait: set[int] = set()
        self.recycled_now: set[int] = set()
        if self.churn is not None:
            self._apply_churn(t)
        if self.wl.streaming:
            # streaming re-shares go FIRST so (a) the coalescing queue
            # batches them into the same enc launch as this round's
            # u1/u2 and (b) their rng draws keep run_protocol's order;
            # the "reshare" message beats the "step" on the same link
            # (scheduler FIFO at equal timestamps).  Under link jitter a
            # step may overtake its re-share — the edge then computes on
            # the previous segment's u3: staleness, never corruption.
            for k in self.wl.reshare(self.wst, t):
                if k not in self.active:
                    continue     # absent edges miss the refresh; their
                                 # rejoin re-runs the whole init phase
                self.last_q[k] = self.last_R[k] = None
                self.u3s[k] = self.wl.share_vector(self.wst, k, self.Bks[k])
                q_alpha = np.asarray(gamma1(self.u3s[k], cfg.spec))
                # accounted in the "iterate" phase (round-synchronous
                # work), matching run_protocol — and groupable with the
                # round's u1/u2 encs without splitting a fused launch
                rt.cq.submit("enc", (q_alpha,),
                             partial(self._reshare_ready, k, t))
                self.reshare_events += 1
                if rt.tracer.enabled:
                    rt.tracer.add("reshare", "reshare", t=rt.sched.now,
                                  edge=k, round=t)
        for k in range(cfg.K):
            if k not in self.active:
                continue                    # frozen handoff block
            u1, u2 = self.wl.iter_inputs(self.wst, k)
            self.w_cur[k] = float(np.sum(u1 + u2))
            qz = np.asarray(gamma2(u1, cfg.spec))
            qv = np.asarray(gamma2(u2, cfg.spec))
            if rt.monitor.enabled:
                cz, tz = gamma2_saturation(qz, cfg.spec)
                cv2, tv2 = gamma2_saturation(qv, cfg.spec)
                rt.monitor.observe_quant(t, cz + cv2, tz + tv2)
            if cfg.recycle and self.last_q[k] is not None \
                    and int(np.max(np.abs(qz - self.last_q[k][0]))) \
                    <= cfg.recycle_tol \
                    and int(np.max(np.abs(qv - self.last_q[k][1]))) \
                    <= cfg.recycle_tol:
                # recycled update: skip enc + step + dec; _finalize
                # re-dequantizes the cached integer chain with THIS
                # round's w-sum (see run_protocol for why tol=0 is exact)
                rt.counter.bump("recycled", rt.nk)
                self.recycled += 1
                self.recycled_now.add(k)
                if rt.tracer.enabled:
                    rt.tracer.add("churn:recycle", "churn", t=rt.sched.now,
                                  edge=k, round=t)
                continue
            self._q_rounds.setdefault(t, {})[k] = (qz, qv)
            rt.cq.submit("enc", (qz,), partial(self._enc_done, t, k, "z"))
            rt.cq.submit("enc", (qv,), partial(self._enc_done, t, k, "v"))
        # the reply barrier for this round: live edges we actually asked
        # (a failed edge stays in here — the master doesn't know yet)
        self._round_edges = self.active - self.recycled_now
        self._w_rounds[t] = self.w_cur
        if not self._round_edges:
            # every live edge recycled: nothing in flight this round
            self._finalize()
            return
        if rt.mode == "deadline":
            rt.sched.after(cfg.deadline, partial(self._on_deadline, t),
                           label=f"deadline:{t}")

    @trace_mod.spanned("driver.callback")
    def _enc_done(self, t: int, k: int, which: str, ct) -> None:
        # ciphertext pairs are keyed by the round that quantized them, so a
        # round closing (deadline) between submit and flush can neither mix
        # its z/v into the next round nor double-send a step; the step goes
        # out tagged with ITS round even if that round is already closed —
        # the edge's late reply then refreshes the stale cache.
        rt = self.rt
        pair = self._cts_rounds.setdefault(t, {}).setdefault(k, {})
        pair[which] = ct
        if len(pair) == 2:
            rt.transport.send(MASTER, edge_name(k), "step",
                              (t, pair["z"], pair["v"]),
                              nbytes=2 * rt.box.ct_bytes(rt.nk))
            del self._cts_rounds[t][k]   # pair consumed; keep the dict flat

    def _on_xhat(self, k: int, t_msg: int, x_hat) -> None:
        # a current-round reply is accepted as long as the round is still
        # open — even past the deadline while the master blocks on a
        # must_wait edge, the actual block beats its stale copy and is not
        # mis-counted as a stale substitution
        if t_msg == self.t and not self.finalized:
            self.replies[k] = x_hat
            self.x_hat_cache[k] = (x_hat, self.w_cur[k], t_msg)
            self.must_wait.discard(k)
            if len(self.replies) == len(self._round_edges) or \
                    (self.deadline_passed and not self.must_wait):
                self._finalize()
            return
        # Straggler reply of a round that already closed on it: never used
        # for that round, but it refreshes the cache (with the w-sum of the
        # round that produced it) so a persistently late edge keeps
        # advancing on recent blocks instead of freezing on one old one.
        w = self._w_rounds.get(t_msg, {}).get(k)
        cached = self.x_hat_cache[k]
        if w is not None and (cached is None or cached[2] < t_msg):
            self.x_hat_cache[k] = (x_hat, w, t_msg)

    def _on_deadline(self, t: int) -> None:
        if t != self.t or self.finalized:
            return
        self.deadline_passed = True
        # block on an edge with no block at all OR one older than the
        # staleness bound (SSP-style): unbounded lag would let a deadline
        # shorter than the physical round-trip freeze blocks forever
        self.must_wait = {
            k for k in self._round_edges
            if k not in self.replies
            and (self.x_hat_cache[k] is None
                 or t - self.x_hat_cache[k][2] > self.rt.stale_limit)}
        if not self.must_wait:
            self._finalize()
        elif self.churn is not None and self.churn.has_fails:
            # a must-wait edge might be dead, and a dead edge never
            # replies — arm the probe chain so the barrier can't hang.
            # Without fails in the schedule every edge eventually
            # answers, so the chain stays off and slow-but-alive edges
            # are never misdeclared.
            self.rt.sched.after(self.rt.cfg.deadline,
                                partial(self._probe, t, 1),
                                label=f"probe:{t}:1")

    def _probe(self, t: int, attempt: int) -> None:
        rt = self.rt
        if t != self.t or self.finalized or not self.must_wait:
            return
        if attempt < rt.fail_detect:
            rt.sched.after(rt.cfg.deadline,
                           partial(self._probe, t, attempt + 1),
                           label=f"probe:{t}:{attempt + 1}")
            return
        # silent past the detection budget (fail_detect deadline periods
        # on top of the stale-cache grace): declare dead and fold the
        # block out — the same handoff semantics as a graceful leave,
        # minus the goodbye
        for k in sorted(self.must_wait):
            self.churn_counts["deaths"] += 1
            self.active.discard(k)
            self._round_edges.discard(k)
            self.wst.aux["churn_active"][k] = False
            self.x_hat_cache[k] = None
            self.last_q[k] = self.last_R[k] = None
            if rt.tracer.enabled:
                rt.tracer.add("churn:dead", "churn", t=rt.sched.now,
                              edge=k, round=t)
            if rt.monitor.enabled:
                rt.monitor.observe_death(t, k)
        self.must_wait.clear()
        self._finalize()

    def _finalize(self) -> None:
        rt, cfg = self.rt, self.rt.cfg
        self.finalized = True
        self._x_new = np.zeros(cfg.K * rt.nk)
        self._n_dec = 0
        self._dec_target = len(self._round_edges)
        stale_before = self.stale_events
        for k in range(cfg.K):
            sl = slice(k * rt.nk, (k + 1) * rt.nk)
            if k not in self.active:
                # departed/dead: frozen at the master's handoff copy
                self._x_new[sl] = self.wst.x_prev[sl]
                continue
            if k in self.recycled_now:
                # recycled update: cached chain, this round's w-sum
                self._x_new[sl] = np.asarray(dequantize_theorem1(
                    self.last_R[k], self.C_rowsums[k], self.w_cur[k],
                    rt.nk, cfg.spec))
                continue
            if k in self.replies:
                x_hat, w_sum, fresh = self.replies[k], self.w_cur[k], True
            else:
                x_hat, w_sum, _ = self.x_hat_cache[k]
                self.stale_events += 1
                fresh = False
            rt.cq.submit("dec", (x_hat,),
                         partial(self._dec_done, k, w_sum, fresh))
        if rt.monitor.enabled:
            rt.monitor.observe_stale(self.t,
                                     self.stale_events - stale_before,
                                     len(self._round_edges))
        if self._dec_target == 0:
            self._round_done()

    @trace_mod.spanned("driver.callback")
    def _dec_done(self, k: int, w_sum: float, fresh: bool, R) -> None:
        rt, cfg = self.rt, self.rt.cfg
        sl = slice(k * rt.nk, (k + 1) * rt.nk)
        R = np.asarray(R).astype(np.float64)
        self._x_new[sl] = np.asarray(dequantize_theorem1(
            R, self.C_rowsums[k], w_sum, rt.nk, cfg.spec))
        if fresh and cfg.recycle:
            # the recycle cache pairs the decrypted chain with the exact
            # quantized inputs that produced it — only a CURRENT-round
            # reply (not a stale substitution) may refresh it
            pair = self._q_rounds.get(self.t, {}).get(k)
            if pair is not None:
                self.last_q[k] = pair
                self.last_R[k] = R
        self._n_dec += 1
        if self._n_dec < self._dec_target:
            return
        self._round_done()

    def _round_done(self) -> None:
        rt, cfg = self.rt, self.rt.cfg
        self._q_rounds.pop(self.t, None)
        if self.wl.uses_secure_agg and rt.tracer.enabled:
            # the z-update aggregate of this round goes through secure
            # aggregation inside global_update below
            rt.tracer.add("secure_agg", "agg", t=rt.sched.now, round=self.t)
        with trace_mod.span("driver.master", self._span_args(self.t)):
            if rt.monitor.enabled:
                # iterate step vs the (t-1) iterate, BEFORE the global
                # update consumes it — the live convergence observable
                rt.monitor.observe_round(self.t, float(np.mean(
                    (self._x_new - self.wst.x_prev) ** 2)))
            # master updates (10b)/(10c) with the (t-1) iterate — Jacobi
            # order
            self.wl.global_update(self.wst, self._x_new)
            self.history[self.t] = self._x_new
        self.iter_times.append(rt.sched.now)
        rt.clock.lap(protocol.PHASE_ITERATE)
        trace_mod.end(self._span)
        if rt.tracer.enabled:
            rt.tracer.add(f"round:{self.t}", "phase", t=self.iter_start,
                          dur=rt.sched.now - self.iter_start, round=self.t)
        nxt = self.t + 1
        cut = cfg.iters
        if self.cancel_after is not None:
            cut = min(cfg.iters, max(1, self.cancel_after))
        if nxt < cut:
            self._iterate(nxt)
        else:
            self.done = True
            self.cancelled = nxt < cfg.iters
            if rt.tracer.enabled:
                rt.tracer.add("phase:iterate", "phase", t=self._phase_t0,
                              dur=rt.sched.now - self._phase_t0)
            if self.on_done is not None:
                self.on_done()


class _Runtime:
    """Wiring bag shared by the actors (scheduler, transport, crypto)."""

    def __init__(self, sched, transport, cq, box, key, counter, cfg, nk,
                 mode, cost, stale_limit, *, device, clock,
                 tracer=trace_mod.NULL, fail_detect=3,
                 monitor=health_mod.NULL_MONITOR):
        self.device = device          # where the big-integer work runs
        # wall seconds per phase and per round, device synchronized at
        # each lap (stats["seconds"], outside the report core)
        self.clock = clock
        self.sched = sched
        self.transport = transport
        self.cq = cq
        self.box = box
        self.key = key
        self.counter = counter
        self.cfg = cfg
        self.nk = nk
        self.mode = mode
        self.cost = cost
        self.stale_limit = stale_limit
        self.tracer = tracer
        self.fail_detect = fail_detect
        self.monitor = monitor
        self.edge_actors: list = []   # filled by run_on_runtime (the
                                      # fault-injection handle for fails)
        # the process's counters so far: waits on the card, exponent
        # paths (obs.metrics.PROCESS)
        self.waits0 = dict(obs_metrics.PROCESS.counters)


def auto_hold_ticks(topo: Topology, transport: Transport, tick_s: float,
                    cap: int = 64) -> int:
    """Hold horizon from the observed link-latency spread (p95/p50).

    Per-edge round-trip latency = 2x the summed per-hop ``latency_s`` on
    the master<->edge route.  The hold covers the straggling tail's extra
    round trip over the median — ``ceil((p95 − p50) / tick)`` — so a late
    edge's ops get to share a launch with its peers (or with the next
    iteration's chain) instead of flushing alone.  Homogeneous links give
    spread 0, i.e. the flush-every-tick default.  Capped at ``cap`` so a
    pathological outlier cannot park the queue indefinitely.
    """
    rtts = []
    for k in range(topo.n_edges):
        path = topo.route(MASTER, edge_name(k))
        rtts.append(2.0 * sum(transport.link_for(u, v).latency_s
                              for u, v in zip(path, path[1:])))
    if len(rtts) < 2:
        return 0
    p50, p95 = np.percentile(rtts, (50, 95))
    if p95 <= p50:
        return 0
    return int(min(cap, math.ceil((p95 - p50) / tick_s)))


def build_runtime(A: np.ndarray, y: np.ndarray,
                  cfg: "protocol.ProtocolConfig", *,
                  workload=None,
                  topology: Topology | None = None,
                  link: LinkModel | None = None,
                  per_link: dict | None = None,
                  mode: str | None = None,
                  tick_s: float = 1e-4,
                  cost_model: dispatch.CostModel | None = None,
                  stale_limit: int = 4,
                  fail_detect: int = 3,
                  table: dict | None = None,
                  calib_path: str | None = None,
                  coalesce_hold_ticks: "int | str" = 0,
                  trace: "bool | trace_mod.Tracer" = False,
                  health: "bool | health_mod.HealthMonitor" = False,
                  sched: "Scheduler | None" = None,
                  make_queue=None,
                  device=None,
                  ):
    """Construct the fully wired runtime WITHOUT running it.

    Factored out of :func:`run_on_runtime` so a serving engine
    (the reference's ``repro.serve.protocol_engine``) can admit many protocol instances
    onto ONE shared virtual clock: pass ``sched`` to reuse a scheduler
    across tenants, and ``make_queue`` (a ``CoalesceQueue``-compatible
    factory with the same positional/keyword signature) to route this
    tenant's crypto ops through a shared cross-tenant collector.
    Returns ``(rt, master, wl, mode)`` — call ``master.start()`` and
    ``rt.sched.run()`` yourself, then hand the quadruple to
    :func:`collect_result` for the RunReport/ledger tail.

    ``trace`` may be ``True`` (allocate a fresh span tracer) or a
    :class:`repro_torch.obs.trace.Tracer` to fill — spans cover phases, rounds,
    kernel launches, crypto ops, messages, dispatch decisions, re-shares
    and secure aggregation; the timing-free signature lands in
    ``stats["runtime"]["trace"]`` and the tracer itself (exportable via
    ``repro_torch.obs.chrome_trace``) is whatever object you passed in.

    ``workload`` selects the ADMM problem family (``repro_torch.workloads``);
    ``None`` resolves ``cfg.workload`` from the registry (default: the
    paper's LASSO, bit-compatible with the historical loop).

    ``coalesce_hold_ticks > 0`` lets the crypto queue hold lone ops for up
    to that many ticks waiting for batch company — useful in deadline mode,
    where heterogeneous link delays otherwise strand late edges' ops in
    singleton launches (and a straggler's chain can merge with the next
    iteration's ops).  0 (default) preserves flush-every-tick semantics;
    ``"auto"`` derives the horizon from the link-latency spread
    (:func:`auto_hold_ticks`) — pass an int to override the heuristic.

    ``health`` may be ``True`` (allocate a fresh
    :class:`repro_torch.obs.health.HealthMonitor`) or a monitor instance —
    live watchers for MSE divergence/stall, quantizer-range saturation,
    stale/death storms and coalesce-queue blowup; fired alerts become
    ``alert`` spans (when tracing) and a ``health`` section in the
    report's ``runtime`` telemetry.  Default off: the
    :class:`~repro_torch.obs.health.NullMonitor` path is allocation-free.

    ``device`` (default ``cfg.device``, the card) is where the cipher box,
    secure aggregation and the collaborative edges run their big-integer
    work, and where ``cipher="auto"`` calibrates; ``"cuda"`` without a
    card raises.
    """
    dev = resolve_device(cfg.device if device is None else device)
    clock = protocol._PhaseClock(dev)
    rng = random.Random(cfg.seed)
    K = cfg.K
    # split-axis contract (see workloads.base.Workload.dims): nk is the
    # per-edge encrypted block — N/K on the column split, the full model
    # width on row-split consensus (the state stacks K copies)
    wl = protocol.resolve_workload(cfg, workload)
    _, nk = wl.dims(A, K)
    mode = mode or ("deadline" if cfg.deadline is not None else "sync")
    if mode == "deadline" and cfg.deadline is None:
        raise ValueError("deadline mode needs cfg.deadline")
    if cfg.churn is not None:
        cfg.churn.check(K, cfg.iters)
        if cfg.churn.has_fails and mode != "deadline":
            raise ValueError(
                "fail events (silent crashes) need deadline mode — sync "
                "mode barriers on every reply and would hang on a dead "
                "edge; use graceful 'leave' events or set cfg.deadline")

    counter = protocol.OpCounter()
    if cfg.cipher == "auto":
        key = gold.keygen(cfg.key_bits, rng)
        protocol.check_plaintext_fits(key, cfg.spec, nk)
        table = table or dispatch.calibrate(
            key_bits=(cfg.key_bits,), batch_sizes=(nk,),
            backends=("gold", "gold_batch", "vec"), path=calib_path,
            warm_key=key, warm_shapes=(nk, (1, nk, nk)), device=dev)
        box = dispatch.AdaptiveBox(key, rng, table, counter=counter,
                                   plain_bits=cfg.spec.plaintext_bits(nk),
                                   device=dev)
    else:
        box, key = protocol.make_box(cfg, nk, rng, counter, device=dev)

    topo = topology or star(K)
    if topo.n_edges != K:
        raise ValueError(f"topology has {topo.n_edges} edges, cfg.K={K}")
    tracer = trace_mod.as_tracer(trace)
    monitor = health_mod.as_monitor(health)
    sched = sched if sched is not None else Scheduler(seed=cfg.seed)
    if monitor.enabled:
        monitor.bind(tracer, clock=lambda: sched.now)
    transport = Transport(sched, topo, default=link, per_link=per_link,
                          tracer=tracer)
    if coalesce_hold_ticks == "auto":
        coalesce_hold_ticks = auto_hold_ticks(topo, transport, tick_s)
    cq = (make_queue or CoalesceQueue)(
        sched, box, counter=counter, tick_s=tick_s,
        hold_ticks=coalesce_hold_ticks, tracer=tracer, monitor=monitor)
    if isinstance(box, dispatch.AdaptiveBox):
        box.tracer = tracer
        box.clock = lambda: sched.now
    cost = cost_model or dispatch.CostModel()
    rt = _Runtime(sched, transport, cq, box, key, counter, cfg, nk, mode,
                  cost, stale_limit, tracer=tracer, fail_detect=fail_detect,
                  monitor=monitor, device=dev, clock=clock)

    master = MasterActor(rt, np.asarray(A, np.float64),
                         np.asarray(y, np.float64), wl)
    transport.bind(MASTER, master.on_message)
    edge_actors = [EdgeActor(k, rt) for k in range(K)]
    rt.edge_actors = edge_actors
    for ea in edge_actors:
        transport.bind(ea.name, ea.on_message)
    # relays are pure forwarding hops: Transport prices them per hop and
    # never delivers to them, so they need no actor.
    return rt, master, wl, mode


def run_on_runtime(A: np.ndarray, y: np.ndarray,
                   cfg: "protocol.ProtocolConfig", *,
                   workload=None,
                   topology: Topology | None = None,
                   link: LinkModel | None = None,
                   per_link: dict | None = None,
                   mode: str | None = None,
                   tick_s: float = 1e-4,
                   cost_model: dispatch.CostModel | None = None,
                   stale_limit: int = 4,
                   fail_detect: int = 3,
                   table: dict | None = None,
                   calib_path: str | None = None,
                   coalesce_hold_ticks: "int | str" = 0,
                   trace: "bool | trace_mod.Tracer" = False,
                   health: "bool | health_mod.HealthMonitor" = False,
                   device=None,
                   ) -> "protocol.ProtocolResult":
    """Run 3P-ADMM-PC2 on the simulated edge network; see module docstring.

    Returns a ``ProtocolResult`` whose ``stats`` is a schema-versioned
    :func:`repro_torch.obs.metrics.build_run_report` RunReport: the usual
    op/traffic counters plus a ``"runtime"`` section (virtual clock,
    per-iteration completion times, per-link bytes, coalescing/dispatch
    telemetry, limb-op roofline), and ``stats["seconds"]`` (outside the
    core) the wall seconds per phase and per round, as ``run_protocol``
    gives them.  In sync mode the report's core sections are identical
    to ``run_protocol``'s.

    All keyword knobs are documented on :func:`build_runtime`, which this
    function composes with :func:`collect_result` — the split exists so
    the multi-tenant serving engine can drive many runtimes on one clock.
    """
    rt, master, wl, mode = build_runtime(
        A, y, cfg, workload=workload, topology=topology, link=link,
        per_link=per_link, mode=mode, tick_s=tick_s, cost_model=cost_model,
        stale_limit=stale_limit, fail_detect=fail_detect, table=table,
        calib_path=calib_path, coalesce_hold_ticks=coalesce_hold_ticks,
        trace=trace, health=health, device=device)
    master.start()
    rt.sched.run()
    if not master.done:
        raise RuntimeError(
            f"runtime drained at t={rt.sched.now:.4f}s before the protocol "
            f"finished (iteration {master.t}/{rt.cfg.iters})")
    return collect_result(rt, master, wl, mode)


@trace_mod.spanned("driver.report")
def collect_result(rt, master, wl, mode, *, driver: str = "runtime",
                   history: np.ndarray | None = None,
                   ledger_extra: dict | None = None,
                   extra_runtime: dict | None = None,
                   ) -> "protocol.ProtocolResult":
    """Assemble the RunReport + ledger record for a finished runtime.

    The tail half of :func:`run_on_runtime`.  ``history`` overrides the
    rows fed to the MSE trajectory (the serving engine truncates it for
    tenants cancelled mid-run), ``ledger_extra`` rides into the ledger
    record, and ``extra_runtime`` is merged into the report's
    ``"runtime"`` telemetry section.
    """
    sched, transport, cq, counter = rt.sched, rt.transport, rt.cq, rt.counter
    box, key, cfg, tracer, monitor = rt.box, rt.key, rt.cfg, rt.tracer, \
        rt.monitor
    topo = transport.topo
    if history is None:
        history = master.history
    traffic = dict(transport.traffic)
    if master.agg_ctx is not None:
        traffic["edge->master"] = traffic.get("edge->master", 0) \
            + master.agg_ctx.traffic_bytes
    key_bits = None if key is None else key.n.bit_length()
    ops = counter.as_dict()
    runtime = {
        "topology": topo.kind,
        "mode": mode,
        "coalesce_hold_ticks": cq.hold_ticks,
        "virtual_time": sched.now,
        "iter_times": list(master.iter_times),
        "events": sched.events_run,
        "max_queue_depth": sched.max_depth,
        "link_bytes": {f"{u}->{v}": n
                       for (u, v), n in sorted(transport.link_bytes.items())},
        "retransmits": transport.retransmits,
        # flat launch counters kept for existing consumers; "coalesce"
        # carries the full telemetry (widths, cold/warm launch walls)
        "coalesced_ops": cq.coalesced_ops,
        "launches": cq.launches,
        "held_flushes": cq.held_flushes,
        "coalesce": cq.metrics_section(),
        # "profile" (process-level events since the previous report) is
        # filled by build_run_report, which drains the global log
        "compile_cache": compile_cache.stats(),
        # the process's waits on the card since the runtime was built (in
        # an engine, every tenant's together: fused launches wait once)
        "waits": obs_metrics.PROCESS.since(rt.waits0, "wait."),
        # the batched CRT ModExp's exponents by path, over the same span
        "exps": obs_metrics.PROCESS.since(rt.waits0, "exps."),
    }
    if key_bits is not None:
        # achieved-vs-peak limb-ops on the virtual clock: utilization of
        # the MODELED device (the paper's speedup-ratio denominator)
        runtime["roofline"] = roofline.achieved_vs_peak(
            ops, key_bits, sched.now)
    if isinstance(box, dispatch.AdaptiveBox):
        runtime["dispatch"] = {
            f"{op}:{b}": n for (op, b), n in sorted(box.choices.items())}
    if tracer.enabled:
        # timing-free structured span signature — byte-identical across
        # seeded runs
        runtime["trace"] = tracer.signature()
    if monitor.enabled:
        runtime["health"] = monitor.health_section()
    if extra_runtime:
        runtime.update(extra_runtime)
    stats = obs_metrics.build_run_report(
        driver=driver, ops=ops, traffic=traffic, key_bits=key_bits,
        cipher=cfg.cipher, workload=wl.name,
        reshare_events=master.reshare_events, history=history,
        churn={**master.churn_counts, "recycled": master.recycled},
        runtime=runtime)
    # run-history ledger: one compact record per completed run (no-op
    # when REPRO_LEDGER is off; never raises)
    ledger_mod.record_run(stats, cfg=cfg, mode=mode, extra=ledger_extra,
                          device=rt.device)
    stats["seconds"] = rt.clock.seconds
    return protocol.ProtocolResult(
        x=master.wst.x_prev, history=history, stats=stats,
        stale_events=master.stale_events)
