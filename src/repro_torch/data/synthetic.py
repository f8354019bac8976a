"""Synthetic LASSO instances (the paper's §V-A/B), copied from
``repro.data.synthetic`` so the same seed gives the same numpy data:
Gaussian compressed matrix with controllable sparsity."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class LassoInstance:
    A: np.ndarray
    y: np.ndarray
    x_true: np.ndarray


def make_lasso(M: int, N: int, sparsity: float = 0.1, noise: float = 0.01,
               seed: int = 0, normalize: bool = True) -> LassoInstance:
    """sparsity = fraction of NONZERO entries in x_true (paper's Fig. 7
    sweeps 10%..90%)."""
    rng = np.random.default_rng(seed)
    A = rng.normal(0.0, 1.0, (M, N)) / (np.sqrt(M) if normalize else 1.0)
    k = max(1, int(round(sparsity * N)))
    x = np.zeros(N)
    idx = rng.choice(N, k, replace=False)
    x[idx] = rng.normal(0.0, 1.0, k)
    y = A @ x + noise * rng.normal(0.0, 1.0, M)
    return LassoInstance(A=A, y=y, x_true=x)
