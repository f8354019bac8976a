"""The cells' inputs, made from the seed.

A LASSO instance as the paper's §V draws it: A with N(0, 1/M) entries, a
sparse ground truth (a tenth of its entries N(0, 1), the rest 0) and
y = A x + noise.  Every seed gives the same sizes; only the values move.
"""
from __future__ import annotations

import numpy as np


def lasso_inputs(M: int, N: int, seed: int, *, sparsity: float,
                 noise: float) -> tuple[np.ndarray, np.ndarray]:
    """``(A, y)`` for one seed (any whole number)."""
    rng = np.random.default_rng(seed % 2 ** 64)
    A = rng.standard_normal((M, N)) / np.sqrt(M)
    nnz = max(1, int(round(sparsity * N)))
    x = np.zeros(N)
    x[rng.choice(N, nnz, replace=False)] = rng.standard_normal(nnz)
    y = A @ x + noise * rng.standard_normal(M)
    return A, y
