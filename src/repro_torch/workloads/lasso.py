"""LASSO — the paper's own problem family (eq. 1), as a workload.

Port of ``repro.workloads.lasso``: the quantizer sees exactly
``(z_k, -v_k)``, ``C_k = rho B_k`` with ``B_k = (A_k^T A_k + rho I)^{-1}``
and ``u3_k = B_k A_k^T ys``, so the ciphertext stream and trajectory
equal the reference's bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import admm as admm_mod
from ..data.synthetic import make_lasso
from . import register
from .base import Workload, WorkloadInstance, ista_block


@register
class LassoWorkload(Workload):
    name = "lasso"
    default_params = {"rho": 1.0, "lam": 0.05}

    def make_instance(self, M: int, N: int, K: int,
                      seed: int = 0, **kw) -> WorkloadInstance:
        inst = make_lasso(M, N, sparsity=kw.pop("sparsity", 0.1),
                          noise=kw.pop("noise", 0.01), seed=seed)
        return WorkloadInstance(A=inst.A, y=inst.y, x_true=inst.x_true)

    def prox_z(self, u: np.ndarray) -> np.ndarray:
        # float64 on the host, the same elementwise formula as the reference
        return admm_mod.soft_threshold(torch.from_numpy(np.asarray(u)),
                                       self.lam / self.rho).numpy()

    def objective(self, A, y, x) -> float:
        r = y - A @ x
        return float(0.5 * np.dot(r, r) + self.lam * np.sum(np.abs(x)))

    def reference_solution(self, A, y, K) -> np.ndarray:
        """Blockwise LASSO on ys — the iteration's fixed point."""
        A = np.asarray(A, np.float64)
        N = A.shape[1]
        Nk = N // K
        ys = np.asarray(y, np.float64) / K
        x = np.zeros(N)
        for k in range(K):
            sl = slice(k * Nk, (k + 1) * Nk)
            x[sl] = ista_block(A[:, sl], ys, l1=self.lam, l2=0.0)
        return x
