"""Elastic net — L1 + L2 regularization, interpolating lasso and ridge.

x-update identical to LASSO; the z-update composes both proxes:
``prox_{(l1‖·‖₁ + l2/2‖·‖²)/rho}(u) = S(u, l1/rho) / (1 + l2/rho)``.
``lam`` is the L1 weight; ``l2`` rides in as a workload param.

Copied from ``repro.workloads.elastic_net`` (numpy only).
"""
from __future__ import annotations

import numpy as np

from . import register
from .base import Workload, WorkloadInstance, ista_block, soft_threshold_np


@register
class ElasticNetWorkload(Workload):
    name = "elastic_net"
    default_params = {"rho": 1.0, "lam": 0.05, "l2": 0.2}

    def __init__(self, rho: float = 1.0, lam: float = 1.0,
                 l2: float = 0.5, **params):
        super().__init__(rho=rho, lam=lam, l2=l2, **params)
        self.l2 = float(l2)

    def make_instance(self, M: int, N: int, K: int,
                      seed: int = 0, **kw) -> WorkloadInstance:
        rng = np.random.default_rng(seed)
        A = rng.normal(0.0, 1.0, (M, N)) / np.sqrt(M)
        k_nz = max(1, int(round(kw.pop("sparsity", 0.2) * N)))
        x = np.zeros(N)
        idx = rng.choice(N, k_nz, replace=False)
        x[idx] = rng.normal(0.0, 1.0, k_nz)
        y = A @ x + kw.pop("noise", 0.01) * rng.normal(0.0, 1.0, M)
        return WorkloadInstance(A=A, y=y, x_true=x)

    def prox_z(self, u: np.ndarray) -> np.ndarray:
        return soft_threshold_np(np.asarray(u), self.lam / self.rho) \
            / (1.0 + self.l2 / self.rho)

    def objective(self, A, y, x) -> float:
        r = y - A @ x
        return float(0.5 * np.dot(r, r) + self.lam * np.sum(np.abs(x))
                     + 0.5 * self.l2 * np.dot(x, x))

    def reference_solution(self, A, y, K) -> np.ndarray:
        """Per-block elastic net on ys via proximal gradient (the fixed
        point of the quadratic family, as for lasso/ridge)."""
        A = np.asarray(A, np.float64)
        N = A.shape[1]
        Nk = N // K
        ys = np.asarray(y, np.float64) / K
        x = np.zeros(N)
        for k in range(K):
            sl = slice(k * Nk, (k + 1) * Nk)
            x[sl] = ista_block(A[:, sl], ys, l1=self.lam, l2=self.l2)
        return x
