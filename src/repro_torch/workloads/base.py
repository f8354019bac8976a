"""Pluggable ADMM problem families for the 3P-ADMM-PC2 privacy protocol.

Port of ``repro.workloads.base`` (numpy on the host, as in the reference,
so the float64 work runs in the same order).  Per iteration the edge
evaluates ONE affine map entirely in ciphertext,

    x_k^{t+1} = u3_k + C_k (u1_k + u2_k),            (eq. 13 generalized)

and a :class:`Workload` names the pieces: ``make_instance`` (synthetic
data), ``dims`` (the split-axis contract: column split, block N/K, or
row-split consensus, block N with K stacked copies), ``edge_setup`` (the
(Q_k, mu, scale) shipped to edge k, which computes
``B_k = (Q_k + mu I)^{-1}`` and quantizes ``C_k = scale B_k``),
``share_vector`` (u3_k, encrypted once), ``reshare`` (the streaming
contract), ``iter_inputs`` (u1_k, u2_k per round), ``global_update`` (the
master's Jacobi-ordered z/v update), evaluation hooks and
``calibrate_spec``.  Row-split families sum their blocks through
:class:`SecureAggContext` (secure aggregation on the run's device).

``simulate_float`` runs the same iteration in plain float64 — the
plaintext baseline and the range rehearsal the calibrator builds on.
"""
from __future__ import annotations

import dataclasses
import math
import random

import numpy as np

from ..core.quantization import QuantSpec


@dataclasses.dataclass(frozen=True)
class WorkloadInstance:
    """One synthetic problem: design matrix, observations, ground truth."""
    A: np.ndarray
    y: np.ndarray
    x_true: np.ndarray | None = None
    meta: dict = dataclasses.field(default_factory=dict)


class WorkloadState:
    """Master-side iteration state: the Jacobi (x, z, v) triple plus any
    workload auxiliaries (gradients, cached block matrices, ...).

    ``dims = (state_dim, block_dim)`` is the workload's split-axis
    contract (:meth:`Workload.dims`): the stacked iterate has
    ``state_dim == K * block_dim`` entries and ``sl(k)`` is edge k's
    block of it.  ``None`` keeps the historical column split."""

    def __init__(self, A: np.ndarray, y: np.ndarray, ys: np.ndarray, K: int,
                 dims: tuple[int, int] | None = None):
        self.A = A
        self.y = y
        self.ys = ys
        self.K = K
        N, self.Nk = dims if dims is not None \
            else (A.shape[1], A.shape[1] // K)
        self.x_prev = np.zeros(N)
        self.z = np.zeros(N)
        self.v = np.zeros(N)
        self.aux: dict = {}

    def sl(self, k: int) -> slice:
        return slice(k * self.Nk, (k + 1) * self.Nk)


@dataclasses.dataclass
class SecureAggContext:
    """How a consensus workload's global aggregate crosses the network.

    Installed into ``WorkloadState.aux["secure_agg"]`` by the protocol
    drivers (never by ``simulate_float`` — the float baseline averages in
    plain float64).  With a Paillier ``key`` the per-edge blocks flow
    through :func:`repro_torch.core.secure_agg.paillier_aggregate` — Gamma_2
    quantize -> encrypt -> ⊕-combine -> only the SUM decrypted.  This
    models the deployment dataflow (each block encrypted as its owning
    worker would, individual contributions hidden from aggregator/relay
    parties); in the single-process simulation the master plays all
    roles, so the demonstrated value is the interaction pattern and its
    op/traffic cost, not blindness of the key holder — see
    :mod:`repro_torch.workloads.consensus` for the scoping.  Without a key
    (the plain cipher arm) the bit-exact plaintext mirror
    :func:`~repro_torch.core.secure_agg.plain_aggregate` runs the identical
    quantize -> integer-sum -> dequantize arithmetic, which is why every
    cipher arm produces the same trajectory bit-for-bit.

    The aggregate's cost is part of the protocol's accounting contract:
    every call bumps the shared ``counter`` with the LOGICAL crypto ops
    (K*n encryptions, the ⊕-combine mulmods, n sum decryptions — same
    structure whichever path runs, mirroring ``PlainBox``'s convention)
    and accrues the worker->aggregator ciphertext bytes in
    ``traffic_bytes`` (``ct_el_bytes`` per element: the cipher box's
    wire width, 8 for the plain arm), which the drivers fold into
    ``stats["traffic_bytes"]["edge->master"]``."""

    spec: QuantSpec
    key: object | None = None
    rng: object | None = None
    counter: object | None = None     # protocol OpCounter (shared)
    ct_el_bytes: int = 8              # wire bytes per ciphertext element
    traffic_bytes: int = 0            # accumulated worker->aggregator bytes
    device: object | None = None      # where the encrypted path runs

    @classmethod
    def for_run(cls, spec: QuantSpec, key, seed: int, counter,
                ct_el_bytes: int, device=None) -> "SecureAggContext":
        """The one construction rule of the protocol driver: the
        aggregation rng is ``Random(seed ^ 0xA66)``, as in the reference,
        and the encrypted path runs on the run's ``device``."""
        return cls(spec=spec, key=key,
                   rng=None if key is None else random.Random(seed ^ 0xA66),
                   counter=counter, ct_el_bytes=ct_el_bytes, device=device)

    def aggregate(self, blocks: list[np.ndarray]) -> np.ndarray:
        from ..core import secure_agg
        Kn, n_el = len(blocks), blocks[0].size
        if self.counter is not None:
            self.counter.bump("enc", Kn * n_el)
            self.counter.bump("mulmod", Kn * n_el)   # ⊕ accumulate
            self.counter.bump("dec", n_el)
        self.traffic_bytes += Kn * n_el * self.ct_el_bytes
        if self.key is None:
            return secure_agg.plain_aggregate(blocks, self.spec)
        return secure_agg.paillier_aggregate(blocks, self.key, self.spec,
                                             rng=self.rng,
                                             device=self.device)


class Workload:
    """Base class: the quadratic consensus family (LASSO-shaped updates).

    Subclasses override the hooks below; the base implementation is the
    column-split quadratic loss  0.5 ||A_k x_k - ys||^2  with a workload
    ``prox_z`` for the regularizer — which covers lasso / ridge /
    elastic_net outright, while logistic re-targets ``edge_setup``,
    ``share_vector`` and ``iter_inputs`` for its prox-linear step.
    """

    name = "base"
    #: split axis of the distributed data: ``"column"`` (the paper's
    #: feature split — each edge owns a column block of A and a slice of
    #: x) or ``"row"`` (sample-parallel consensus — each edge owns its
    #: own rows of A and iterates a full-width copy of x).  Informational
    #: label; the operative contract is :meth:`dims`.
    split = "column"
    #: True for families whose per-edge data changes mid-run (streaming
    #: y, sliding windows): the protocol calls :meth:`reshare` at the
    #: top of every round and re-runs the encrypted share phase for the
    #: edges it names.
    streaming = False
    #: True for families whose global update sums per-edge iterate
    #: blocks through secure aggregation (row-split consensus): the
    #: protocol installs a :class:`SecureAggContext` into the state so
    #: the aggregate crosses the network encrypted (or through the
    #: bit-exact plaintext mirror on the plain arm).
    uses_secure_agg = False
    #: default quantization grid for ``calibrate_spec``.  Families whose
    #: iteration feeds the decrypted iterate back through data-dependent
    #: terms (logistic's gradient) amplify rounding error and override
    #: this with a finer grid — the Remark-2 width check still gates it.
    delta = 1e6
    #: recommended constructor kwargs — what registry-driven callers
    #: (``get_default``: the conformance tests, ``chip_smoke.py``) build
    #: the family with, so a newly registered workload works there
    #: without editing any hand-kept table.
    default_params: dict = {}

    def __init__(self, rho: float = 1.0, lam: float = 1.0, **params):
        self.rho = float(rho)
        self.lam = float(lam)
        self.params = params

    # -- data -------------------------------------------------------------
    def make_instance(self, M: int, N: int, K: int,
                      seed: int = 0, **kw) -> WorkloadInstance:
        raise NotImplementedError

    # -- split-axis contract ----------------------------------------------
    def dims(self, A: np.ndarray, K: int) -> tuple[int, int]:
        """``(state_dim, block_dim)`` of the distributed iterate.

        ``block_dim`` is the length of every per-edge encrypted block
        (the protocol's ciphertext batch size, Remark-2 chain width);
        ``state_dim == K * block_dim`` is the master's stacked iterate.
        Column split (default): x is partitioned, ``block_dim =
        ceil(N/K)``.  When K does not divide N the state is padded
        internally — ``init_state`` appends zero columns to A, the dead
        coordinates converge to 0 under the ridge-regularized block
        solve, and :meth:`fold_solution` strips them — so ragged feature
        counts run through the protocol unchanged.
        Row split (consensus): every edge holds a full-width local copy,
        ``block_dim = N`` and the state stacks K copies (ragged M is
        padded with inert zero ROWS instead; see consensus.py)."""
        N = A.shape[1]
        Nk = -(-N // K)                      # ceil: internal padding
        return K * Nk, Nk

    # -- state ------------------------------------------------------------
    def init_state(self, A: np.ndarray, y: np.ndarray, ys: np.ndarray,
                   K: int, y_scale: str = "consistent") -> WorkloadState:
        """``y_scale`` records the driver's convention for deriving
        ``ys`` from ``y`` ("consistent" = y/K), so hooks that rebuild
        ``ys`` mid-run (streaming re-shares) keep it."""
        A = np.asarray(A, np.float64)
        dims = self.dims(A, K)
        if self.split == "column" and dims[0] > A.shape[1]:
            # ragged column split: pad A with zero columns up to K*Nk.
            # The padded coordinates see no data (zero column => zero
            # gradient) and a mu-regularized block solve, so they sit at
            # 0 throughout; fold_solution(x, K, n=N) strips them.
            A = np.concatenate(
                [A, np.zeros((A.shape[0], dims[0] - A.shape[1]))], axis=1)
        st = WorkloadState(A, np.asarray(y, np.float64),
                           np.asarray(ys, np.float64), K, dims=dims)
        st.y_scale = y_scale
        return st

    # -- initialization phase --------------------------------------------
    def edge_setup(self, st: WorkloadState, k: int
                   ) -> tuple[np.ndarray, float, float]:
        """(Q_k, mu, scale): edge computes B_k = (Q_k + mu I)^{-1} and
        keeps Gamma_2(scale * B_k)."""
        Ak = st.A[:, st.sl(k)]
        return Ak.T @ Ak, self.rho, self.rho

    def share_vector(self, st: WorkloadState, k: int,
                     Bk: np.ndarray) -> np.ndarray:
        """u3_k — encrypted once in the data-security-sharing phase."""
        Ak = st.A[:, st.sl(k)]
        return Bk @ (Ak.T @ st.ys)

    # -- streaming contract ------------------------------------------------
    def reshare(self, st: WorkloadState, t: int):
        """Advance any time-varying data and name the edges to re-share.

        Called by the protocol at the top of every round ``t`` when
        ``streaming`` is True.  Mutate ``st`` (slide the window, ingest
        the next y segment, ...) and return the iterable of edge indices
        whose ``share_vector`` output changed — the protocol re-runs the
        data-security-sharing phase for exactly those edges (fresh
        Gamma_1 quantize -> encrypt -> ship, coalesced with the round's
        u1/u2 encryptions).  ``C_k`` is fixed per run by contract: only
        u3 may vary.  Return an empty iterable when nothing changed."""
        return ()

    # -- parallel privacy-computing phase --------------------------------
    def iter_inputs(self, st: WorkloadState, k: int
                    ) -> tuple[np.ndarray, np.ndarray]:
        """(u1_k, u2_k) for this round — both Gamma_2-quantized+encrypted."""
        sl = st.sl(k)
        return st.z[sl], -st.v[sl]

    def global_update(self, st: WorkloadState, x_new: np.ndarray) -> None:
        """Master's (10b)/(10c) with the (t-1) iterate — Jacobi order.

        Under churn (``st.aux["churn_active"]``, a length-K bool mask the
        drivers maintain) a departed edge's block is FROZEN: its (z, v)
        slice keeps its handoff value, mirroring the frozen x block the
        driver writes into ``x_new`` — the whole block state resumes
        unchanged on rejoin."""
        z_new = np.asarray(self.prox_z(st.v + st.x_prev))
        v_new = st.v + st.x_prev - z_new
        act = st.aux.get("churn_active")
        if act is not None and not act.all():
            m = np.repeat(np.asarray(act, bool), st.Nk)
            z_new = np.where(m, z_new, st.z)
            v_new = np.where(m, v_new, st.v)
        st.v = v_new
        st.z = z_new
        st.x_prev = x_new

    def prox_z(self, u: np.ndarray) -> np.ndarray:
        """prox_{r/rho} of the regularizer — the z-update."""
        raise NotImplementedError

    # -- evaluation -------------------------------------------------------
    def objective(self, A: np.ndarray, y: np.ndarray,
                  x: np.ndarray) -> float:
        raise NotImplementedError

    def reference_solution(self, A: np.ndarray, y: np.ndarray,
                           K: int) -> np.ndarray:
        """What the distributed iteration converges to (closed form or a
        trusted independent solver) — the convergence-test oracle."""
        raise NotImplementedError

    def fold_solution(self, x: np.ndarray, K: int,
                      n: int | None = None) -> np.ndarray:
        """Collapse the master's stacked iterate to one model estimate.

        Identity for column split (the stacked iterate IS the model);
        row-split consensus averages its K full-width copies.  ``n``
        (the model width, ``A.shape[1]``) strips the internal padding a
        ragged column split appends — omit it for divisible dims.
        Callers that compare a protocol solution against an
        N-dimensional truth (edge_sim, workload_zoo, the convergence
        tests) fold first."""
        x = np.asarray(x)
        return x if n is None else x[:n]

    def metrics(self, inst: WorkloadInstance, x: np.ndarray) -> dict:
        x = np.asarray(x)[:inst.A.shape[1]]   # strip ragged-split padding
        out = {"objective": self.objective(inst.A, inst.y, x)}
        if inst.x_true is not None:
            out["mse_vs_truth"] = float(np.mean((x - inst.x_true) ** 2))
        return out

    # -- quantization-range calibration ----------------------------------
    def calibrate_spec(self, A: np.ndarray, y: np.ndarray, K: int,
                       iters: int, delta: float | None = None,
                       margin: float = 2.0,
                       y_scale: str = "consistent",
                       churn=None) -> QuantSpec:
        """Pick a symmetric [−zmax, zmax] covering every quantized value.

        Rehearses the iteration in plain float64 (``simulate_float``)
        tracking the max magnitude over all Gamma inputs — C_k entries,
        u3_k, and every round's (u1_k, u2_k) — then pads by ``margin``
        and rounds zmax up to a power of two (deterministic, so all
        cipher arms derive the same spec).  In-range inputs are exactly
        what Theorem 1 needs for the dequantization to be exact up to
        quantization rounding.  A churned run passes its
        :class:`~repro_torch.core.churn.ChurnSchedule` so the rehearsal walks
        the same membership trajectory (the consensus z-prox rescales to
        the active count, which can shift the range).
        """
        _, _, vmax = simulate_float(self, A, y, K, iters,
                                    y_scale=y_scale, track_range=True,
                                    churn=churn)
        zmax = float(2.0 ** math.ceil(math.log2(max(margin * vmax, 1.0))))
        return QuantSpec(delta=self.delta if delta is None else delta,
                         zmin=-zmax, zmax=zmax)


# ---------------------------------------------------------------------------
# Plaintext distributed baseline (and range rehearsal)
# ---------------------------------------------------------------------------

def simulate_float(wl: Workload, A: np.ndarray, y: np.ndarray, K: int,
                   iters: int, y_scale: str = "consistent",
                   track_range: bool = False, churn=None):
    """The workload's distributed iteration in plain float64 — no
    quantization, no encryption.  Returns ``(x, history)`` or, with
    ``track_range=True``, ``(x, history, vmax)`` where ``vmax`` is the
    largest magnitude that entered any Gamma quantizer slot (including
    every re-shared u3 of a streaming family and every rejoin re-run).

    ``churn`` (a :class:`~repro_torch.core.churn.ChurnSchedule`) replays the
    same membership trajectory the protocol drivers walk: departed
    blocks freeze, rejoins re-run edge setup, and the workload's
    ``churn_active`` mask gates the global update — so the calibrator's
    range rehearsal covers churned runs too (fail events rehearse as
    leaves: the range only depends on which blocks participate)."""
    A = np.asarray(A, np.float64)
    y = np.asarray(y, np.float64)
    N_state, Nk = wl.dims(A, K)
    ys = y / K if y_scale == "consistent" else y
    st = wl.init_state(A, y, ys, K, y_scale=y_scale)
    active = set(range(K))
    if churn is not None:
        churn.check(K, iters)
        st.aux["churn_active"] = np.ones(K, dtype=bool)
    vmax = 0.0

    def setup_edge(k):
        Q, mu, scale = wl.edge_setup(st, k)
        Bk = np.linalg.inv(Q + mu * np.eye(Nk))
        return scale * Bk, Bk, wl.share_vector(st, k, Bk)

    Cs, Bks, u3s = [], [], []
    for k in range(K):
        C, Bk, u3 = setup_edge(k)
        Cs.append(C)
        Bks.append(Bk)
        u3s.append(u3)
        if track_range:
            vmax = max(vmax, float(np.max(np.abs(C))),
                       float(np.max(np.abs(u3))) if u3.size else 0.0)
    history = np.zeros((iters, N_state))
    for t in range(iters):
        if churn is not None:
            for ev in churn.events_at(t):
                if ev.kind == "rejoin":
                    active.add(ev.edge)
                    st.aux["churn_active"][ev.edge] = True
                    # full init-phase re-run: C_k and u3_k rebuilt from
                    # the CURRENT state (the generalized reshare contract)
                    Cs[ev.edge], Bks[ev.edge], u3s[ev.edge] = \
                        setup_edge(ev.edge)
                    if track_range:
                        vmax = max(vmax, float(np.max(np.abs(Cs[ev.edge]))),
                                   float(np.max(np.abs(u3s[ev.edge])))
                                   if u3s[ev.edge].size else 0.0)
                else:  # leave | fail — block frozen either way
                    active.discard(ev.edge)
                    st.aux["churn_active"][ev.edge] = False
        if wl.streaming:
            for k in wl.reshare(st, t):
                if k not in active:
                    continue        # absent edges miss the refresh
                u3s[k] = wl.share_vector(st, k, Bks[k])
                if track_range and u3s[k].size:
                    vmax = max(vmax, float(np.max(np.abs(u3s[k]))))
        x_new = np.zeros(N_state)
        for k in range(K):
            sl = st.sl(k)
            if k not in active:
                x_new[sl] = st.x_prev[sl]     # frozen handoff block
                continue
            u1, u2 = wl.iter_inputs(st, k)
            if track_range:
                vmax = max(vmax, float(np.max(np.abs(u1))),
                           float(np.max(np.abs(u2))))
            x_new[sl] = u3s[k] + Cs[k] @ (u1 + u2)
        if track_range and wl.uses_secure_agg:
            # the secure-aggregation quantizer sees x_new + v (pre-update
            # v) — cover it explicitly rather than relying on margin >= 2
            # to absorb the |x| + |v| sum
            vmax = max(vmax, float(np.max(np.abs(x_new + st.v))))
        wl.global_update(st, x_new)
        history[t] = x_new
    if track_range:
        # the decrypted iterate feeds the next round's inputs; cover it too
        vmax = max(vmax, float(np.max(np.abs(history))) if iters else 0.0)
        return st.x_prev, history, vmax
    return st.x_prev, history


# ---------------------------------------------------------------------------
# Shared numeric helpers for the concrete families
# ---------------------------------------------------------------------------

def soft_threshold_np(x: np.ndarray, t: float) -> np.ndarray:
    return np.sign(x) * np.maximum(np.abs(x) - t, 0.0)


def ista_block(Ak: np.ndarray, ys: np.ndarray, l1: float, l2: float,
               iters: int = 4000) -> np.ndarray:
    """Proximal gradient for  0.5||A_k x − ys||² + l1‖x‖₁ + l2/2‖x‖² —
    the per-block fixed point of the quadratic consensus family."""
    L = float(np.linalg.norm(Ak, 2) ** 2) + l2
    step = 1.0 / max(L, 1e-12)
    x = np.zeros(Ak.shape[1])
    for _ in range(iters):
        g = Ak.T @ (Ak @ x - ys) + l2 * x
        x = soft_threshold_np(x - step * g, l1 * step)
    return x
