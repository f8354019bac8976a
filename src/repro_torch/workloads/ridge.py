"""Ridge regression — quadratic loss + L2, with an EXACT closed form.

Same encrypted x-update as LASSO (``C_k = rho B_k``, ``u3_k = B_k A_k^T
ys``); only the master's z-update differs: the prox of (lam/2)‖z‖² is a
pure shrinkage ``u / (1 + lam/rho)``.  The fixed point is available in
closed form — eliminating (z, v) at the fixed point gives ``v = lam
x/rho`` and hence ``(A_k^T A_k + lam I) x_k = A_k^T ys`` per block —
which is what makes ridge the sharpest convergence oracle in the zoo
(the protocol lands on it).

Copied from ``repro.workloads.ridge`` (numpy only).
"""
from __future__ import annotations

import numpy as np

from . import register
from .base import Workload, WorkloadInstance


@register
class RidgeWorkload(Workload):
    name = "ridge"
    default_params = {"rho": 1.0, "lam": 0.1}

    def make_instance(self, M: int, N: int, K: int,
                      seed: int = 0, **kw) -> WorkloadInstance:
        rng = np.random.default_rng(seed)
        A = rng.normal(0.0, 1.0, (M, N)) / np.sqrt(M)
        x = rng.normal(0.0, 1.0, N)          # dense truth (no sparsity prior)
        y = A @ x + kw.pop("noise", 0.01) * rng.normal(0.0, 1.0, M)
        return WorkloadInstance(A=A, y=y, x_true=x)

    def prox_z(self, u: np.ndarray) -> np.ndarray:
        return np.asarray(u) / (1.0 + self.lam / self.rho)

    def objective(self, A, y, x) -> float:
        r = y - A @ x
        return float(0.5 * np.dot(r, r) + 0.5 * self.lam * np.dot(x, x))

    def reference_solution(self, A, y, K) -> np.ndarray:
        """Exact blockwise solve  (A_k^T A_k + lam I) x_k = A_k^T ys."""
        A = np.asarray(A, np.float64)
        N = A.shape[1]
        Nk = N // K
        ys = np.asarray(y, np.float64) / K
        x = np.zeros(N)
        for k in range(K):
            sl = slice(k * Nk, (k + 1) * Nk)
            Ak = A[:, sl]
            x[sl] = np.linalg.solve(Ak.T @ Ak + self.lam * np.eye(Nk),
                                    Ak.T @ ys)
        return x
