"""Logistic-regression consensus training — the abstract's "multiple edge
nodes use distributed data to train a global model" scenario.

Prox-linear (linearized) ADMM: the logistic loss F(x) = Σᵢ softplus(aᵢᵀx)
− bᵢ aᵢᵀx has no closed-form x-update, so each round minimizes its
quadratic model at the previous iterate with the curvature upper bound
H_k = ¼ A_k^T A_k + tau I (the logistic Hessian satisfies A^T D A ⪯ ¼
A^T A; ``tau`` additionally dominates the cross-block curvature the
Jacobi update ignores):

    x_k^{t+1} = argmin ⟨g_k^t, x⟩ + ½‖x − x_k^t‖²_{H_k}
                        + (rho/2)‖x − z_k^t + v_k^t‖²
              = B_k [ H_k x_k^t − g_k^t + rho (z_k^t − v_k^t) ],
    B_k = (H_k + rho I)^{-1},      g_k^t = A_k^T (sigmoid(A x^t) − b).

Cast into the protocol's affine ciphertext map with ``C_k = rho B_k``:

    u1_k = (H_k x_k^t − g_k^t)/rho + z_k^t,    u2_k = −v_k^t,   u3_k = 0.

The master recomputes the (plaintext) gradient each round — it owns the
data and the decrypted iterate; the edge still evaluates the whole
x-update homomorphically and sees only quantized/encrypted material.
At the fixed point ``v = lam x / rho`` (ridge prox on z) and the update
collapses to ``g_k + lam x_k = 0`` for every block — i.e. the TRUE
centralized L2-regularized logistic optimum, which is why the
convergence test can compare against plain full-batch gradient descent.

Copied from ``repro.workloads.logistic`` (numpy only).
"""
from __future__ import annotations

import numpy as np

from . import register
from .base import Workload, WorkloadInstance, WorkloadState


def _sigmoid(s: np.ndarray) -> np.ndarray:
    out = np.empty_like(s)
    pos = s >= 0
    out[pos] = 1.0 / (1.0 + np.exp(-s[pos]))
    es = np.exp(s[~pos])
    out[~pos] = es / (1.0 + es)
    return out


def _softplus(s: np.ndarray) -> np.ndarray:
    return np.maximum(s, 0.0) + np.log1p(np.exp(-np.abs(s)))


@register
class LogisticWorkload(Workload):
    name = "logistic"
    default_params = {"rho": 1.0, "lam": 0.1}
    # the decrypted iterate feeds the next linearization point, so
    # rounding error recirculates through the gradient — a finer grid
    # keeps the accumulated drift at the 1e-4 level over ~50 rounds
    # (still int64-safe at Nk <= 200 and ~57 plaintext bits)
    delta = 1e8

    def __init__(self, rho: float = 1.0, lam: float = 0.1, **params):
        super().__init__(rho=rho, lam=lam, **params)

    def make_instance(self, M: int, N: int, K: int,
                      seed: int = 0, **kw) -> WorkloadInstance:
        rng = np.random.default_rng(seed)
        A = rng.normal(0.0, 1.0, (M, N)) / np.sqrt(N)
        x = rng.normal(0.0, 2.0, N)
        p = _sigmoid(A @ x)
        b = (rng.random(M) < p).astype(np.float64)     # labels in {0, 1}
        return WorkloadInstance(A=A, y=b, x_true=x)

    # -- state: cached block curvatures + the running full gradient -------
    def init_state(self, A, y, ys, K,
                   y_scale: str = "consistent") -> WorkloadState:
        st = super().init_state(A, y, ys, K, y_scale=y_scale)
        # tau dominates the cross-block curvature ¼ A_k^T A_j the Jacobi
        # step drops (the global bound is ¼ sigma_max(A)^2)
        tau = 0.25 * float(np.linalg.norm(st.A, 2) ** 2)
        st.aux["H"] = []
        for k in range(K):
            Ak = st.A[:, st.sl(k)]
            st.aux["H"].append(0.25 * (Ak.T @ Ak) + tau * np.eye(st.Nk))
        st.aux["g"] = self._gradient(st, st.x_prev)
        return st

    def _gradient(self, st: WorkloadState, x: np.ndarray) -> np.ndarray:
        return st.A.T @ (_sigmoid(st.A @ x) - st.y)

    # -- protocol hooks ---------------------------------------------------
    def edge_setup(self, st, k):
        return st.aux["H"][k], self.rho, self.rho     # B_k = (H_k + rho)^-1

    def share_vector(self, st, k, Bk) -> np.ndarray:
        return np.zeros(st.Nk)                        # u3 = 0

    def iter_inputs(self, st, k):
        sl = st.sl(k)
        u1 = (st.aux["H"][k] @ st.x_prev[sl] - st.aux["g"][sl]) / self.rho \
            + st.z[sl]
        return u1, -st.v[sl]

    def global_update(self, st, x_new) -> None:
        super().global_update(st, x_new)              # z/v Jacobi + x_prev
        st.aux["g"] = self._gradient(st, st.x_prev)   # fresh linearization

    def prox_z(self, u: np.ndarray) -> np.ndarray:
        return np.asarray(u) / (1.0 + self.lam / self.rho)

    # -- evaluation -------------------------------------------------------
    def objective(self, A, y, x) -> float:
        s = np.asarray(A, np.float64) @ x
        return float(np.sum(_softplus(s) - y * s)
                     + 0.5 * self.lam * np.dot(x, x))

    def reference_solution(self, A, y, K, iters: int = 20000) -> np.ndarray:
        """Centralized full-batch gradient descent on F(x) + lam/2‖x‖²."""
        A = np.asarray(A, np.float64)
        y = np.asarray(y, np.float64)
        L = 0.25 * float(np.linalg.norm(A, 2) ** 2) + self.lam
        step = 1.0 / L
        x = np.zeros(A.shape[1])
        for _ in range(iters):
            g = A.T @ (_sigmoid(A @ x) - y) + self.lam * x
            x_new = x - step * g
            if float(np.max(np.abs(x_new - x))) < 1e-12:
                return x_new
            x = x_new
        return x

    def metrics(self, inst: WorkloadInstance, x: np.ndarray) -> dict:
        out = super().metrics(inst, x)
        pred = _sigmoid(inst.A @ x) >= 0.5
        out["train_accuracy"] = float(np.mean(pred == (inst.y >= 0.5)))
        g = inst.A.T @ (_sigmoid(inst.A @ x) - inst.y) + self.lam * x
        out["grad_norm"] = float(np.linalg.norm(g))
        return out
