"""Pluggable ADMM problem families for the 3P-ADMM-PC2 privacy protocol.

Port of ``repro.workloads.base`` (numpy on the host, as in the reference).
Per iteration the edge evaluates ONE affine map entirely in ciphertext,

    x_k^{t+1} = u3_k + C_k (u1_k + u2_k),            (eq. 13 generalized)

and a :class:`Workload` names the pieces: ``make_instance`` (synthetic
data), ``dims`` (the split-axis contract), ``edge_setup`` (the
(Q_k, mu, scale) shipped to edge k, which computes
``B_k = (Q_k + mu I)^{-1}`` and quantizes ``C_k = scale B_k``),
``share_vector`` (u3_k, encrypted once), ``reshare`` (the streaming
contract), ``iter_inputs`` (u1_k, u2_k per round), ``global_update`` (the
master's Jacobi-ordered z/v update), evaluation hooks and
``calibrate_spec``.  Secure aggregation (row-split consensus families)
arrives with a later slice.
"""
from __future__ import annotations

import dataclasses
import math

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
    workload auxiliaries.  ``dims = (state_dim, block_dim)``; ``sl(k)`` is
    edge k's block of the stacked iterate."""

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


class Workload:
    """Base class: the column-split quadratic loss 0.5 ||A_k x_k - ys||^2
    with a workload ``prox_z`` for the regularizer."""

    name = "base"
    split = "column"
    streaming = False
    uses_secure_agg = False
    delta = 1e6
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
        """``(state_dim, block_dim)``: column split, ``block_dim =
        ceil(N/K)`` (a ragged split is padded inside ``init_state``)."""
        N = A.shape[1]
        Nk = -(-N // K)
        return K * Nk, Nk

    # -- state ------------------------------------------------------------
    def init_state(self, A: np.ndarray, y: np.ndarray, ys: np.ndarray,
                   K: int, y_scale: str = "consistent") -> WorkloadState:
        A = np.asarray(A, np.float64)
        dims = self.dims(A, K)
        if self.split == "column" and dims[0] > A.shape[1]:
            # ragged column split: zero columns up to K*Nk stay at 0
            A = np.concatenate(
                [A, np.zeros((A.shape[0], dims[0] - A.shape[1]))], axis=1)
        st = WorkloadState(A, np.asarray(y, np.float64),
                           np.asarray(ys, np.float64), K, dims=dims)
        st.y_scale = y_scale
        return st

    # -- initialization phase --------------------------------------------
    def edge_setup(self, st: WorkloadState, k: int
                   ) -> tuple[np.ndarray, float, float]:
        Ak = st.A[:, st.sl(k)]
        return Ak.T @ Ak, self.rho, self.rho

    def share_vector(self, st: WorkloadState, k: int,
                     Bk: np.ndarray) -> np.ndarray:
        Ak = st.A[:, st.sl(k)]
        return Bk @ (Ak.T @ st.ys)

    # -- streaming contract ------------------------------------------------
    def reshare(self, st: WorkloadState, t: int):
        return ()

    # -- parallel privacy-computing phase --------------------------------
    def iter_inputs(self, st: WorkloadState, k: int
                    ) -> tuple[np.ndarray, np.ndarray]:
        sl = st.sl(k)
        return st.z[sl], -st.v[sl]

    def global_update(self, st: WorkloadState, x_new: np.ndarray) -> None:
        """Master's (10b)/(10c) with the (t-1) iterate — Jacobi order."""
        z_new = np.asarray(self.prox_z(st.v + st.x_prev))
        v_new = st.v + st.x_prev - z_new
        st.v = v_new
        st.z = z_new
        st.x_prev = x_new

    def prox_z(self, u: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    # -- evaluation -------------------------------------------------------
    def objective(self, A: np.ndarray, y: np.ndarray,
                  x: np.ndarray) -> float:
        raise NotImplementedError

    def reference_solution(self, A: np.ndarray, y: np.ndarray,
                           K: int) -> np.ndarray:
        raise NotImplementedError

    def fold_solution(self, x: np.ndarray, K: int,
                      n: int | None = None) -> np.ndarray:
        x = np.asarray(x)
        return x if n is None else x[:n]

    def metrics(self, inst: WorkloadInstance, x: np.ndarray) -> dict:
        x = np.asarray(x)[:inst.A.shape[1]]
        out = {"objective": self.objective(inst.A, inst.y, x)}
        if inst.x_true is not None:
            out["mse_vs_truth"] = float(np.mean((x - inst.x_true) ** 2))
        return out

    # -- quantization-range calibration ----------------------------------
    def calibrate_spec(self, A: np.ndarray, y: np.ndarray, K: int,
                       iters: int, delta: float | None = None,
                       margin: float = 2.0,
                       y_scale: str = "consistent") -> QuantSpec:
        """A symmetric [-zmax, zmax] covering every quantized value of a
        float64 rehearsal, padded by ``margin`` and rounded up to a power
        of two."""
        _, _, vmax = simulate_float(self, A, y, K, iters,
                                    y_scale=y_scale, track_range=True)
        zmax = float(2.0 ** math.ceil(math.log2(max(margin * vmax, 1.0))))
        return QuantSpec(delta=self.delta if delta is None else delta,
                         zmin=-zmax, zmax=zmax)


def simulate_float(wl: Workload, A: np.ndarray, y: np.ndarray, K: int,
                   iters: int, y_scale: str = "consistent",
                   track_range: bool = False):
    """The workload's distributed iteration in plain float64 — no
    quantization, no encryption.  Returns ``(x, history)`` or, with
    ``track_range=True``, ``(x, history, vmax)``."""
    A = np.asarray(A, np.float64)
    y = np.asarray(y, np.float64)
    N_state, Nk = wl.dims(A, K)
    ys = y / K if y_scale == "consistent" else y
    st = wl.init_state(A, y, ys, K, y_scale=y_scale)
    vmax = 0.0
    Cs, Bks, u3s = [], [], []
    for k in range(K):
        Q, mu, scale = wl.edge_setup(st, k)
        Bk = np.linalg.inv(Q + mu * np.eye(Nk))
        Cs.append(scale * Bk)
        Bks.append(Bk)
        u3s.append(wl.share_vector(st, k, Bk))
        if track_range:
            vmax = max(vmax, float(np.max(np.abs(Cs[k]))),
                       float(np.max(np.abs(u3s[k]))) if u3s[k].size else 0.0)
    history = np.zeros((iters, N_state))
    for t in range(iters):
        if wl.streaming:
            for k in wl.reshare(st, t):
                u3s[k] = wl.share_vector(st, k, Bks[k])
                if track_range and u3s[k].size:
                    vmax = max(vmax, float(np.max(np.abs(u3s[k]))))
        x_new = np.zeros(N_state)
        for k in range(K):
            sl = st.sl(k)
            u1, u2 = wl.iter_inputs(st, k)
            if track_range:
                vmax = max(vmax, float(np.max(np.abs(u1))),
                           float(np.max(np.abs(u2))))
            x_new[sl] = u3s[k] + Cs[k] @ (u1 + u2)
        wl.global_update(st, x_new)
        history[t] = x_new
    if track_range:
        vmax = max(vmax, float(np.max(np.abs(history))) if iters else 0.0)
        return st.x_prev, history, vmax
    return st.x_prev, history


def soft_threshold_np(x: np.ndarray, t: float) -> np.ndarray:
    return np.sign(x) * np.maximum(np.abs(x) - t, 0.0)


def ista_block(Ak: np.ndarray, ys: np.ndarray, l1: float, l2: float,
               iters: int = 4000) -> np.ndarray:
    """Proximal gradient for  0.5||A_k x - ys||^2 + l1||x||_1 + l2/2||x||^2
    — the per-block fixed point of the quadratic consensus family."""
    L = float(np.linalg.norm(Ak, 2) ** 2) + l2
    step = 1.0 / max(L, 1e-12)
    x = np.zeros(Ak.shape[1])
    for _ in range(iters):
        g = Ak.T @ (Ak @ x - ys) + l2 * x
        x = soft_threshold_np(x - step * g, l1 * step)
    return x
