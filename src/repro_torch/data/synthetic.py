"""Synthetic data generators, copied from ``repro.data.synthetic`` so the
same seed gives the same numpy data.

* LASSO instances (the paper's §V-A/B): Gaussian compressed matrix,
  controllable sparsity.
* Power-network reconstruction (§V-C): sparse admittance graph, voltage
  observations, per-bus LASSO instances.
* Token streams for the LM trainer (``token_batch``): a deterministic
  function of (seed, step), so a resumed run replays the same batches.
"""
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


# ---------------------------------------------------------------------------
# Power network (§V-C)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PowerNetwork:
    adjacency: np.ndarray      # (N, N) binary (the ground truth to recover)
    admittance: np.ndarray     # (N, N) weighted symmetric
    voltages: np.ndarray       # (T, N) observations
    currents: np.ndarray       # (T, N) I = V @ Y (Kirchhoff)


def make_power_network(n_bus: int, avg_degree: float = 3.0, T: int = 200,
                       noise: float = 1e-3, seed: int = 0) -> PowerNetwork:
    rng = np.random.default_rng(seed)
    p = avg_degree / max(n_bus - 1, 1)
    upper = rng.random((n_bus, n_bus)) < p
    upper = np.triu(upper, 1)
    adj = (upper | upper.T).astype(np.float64)
    w = rng.uniform(0.5, 2.0, (n_bus, n_bus))
    Y = adj * (w + w.T) / 2.0
    np.fill_diagonal(Y, 0.0)
    d = Y.sum(1)
    L = np.diag(d) - Y                    # weighted Laplacian
    V = rng.normal(0.0, 1.0, (T, n_bus))
    I = V @ L.T + noise * rng.normal(0.0, 1.0, (T, n_bus))
    return PowerNetwork(adjacency=adj, admittance=Y, voltages=V, currents=I)


def bus_lasso(net: PowerNetwork, bus: int) -> LassoInstance:
    """Per-bus reconstruction instance: S_i = Phi_i d_i (eq. 50).

    Phi_i[t, j] = V_i(t) - V_j(t); d_i[j] = Y_ij (column j != i)."""
    V = net.voltages
    phi = V[:, bus][:, None] - V                      # (T, N)
    phi[:, bus] = V[:, bus]                           # self column: diagonal
    d_true = net.admittance[bus].copy()
    d_true[bus] = net.admittance[bus].sum()           # Laplacian diagonal
    S = net.currents[:, bus]
    return LassoInstance(A=phi, y=S, x_true=d_true)


# ---------------------------------------------------------------------------
# Token streams
# ---------------------------------------------------------------------------

def token_batch(vocab: int, batch: int, seq: int, step: int, seed: int = 0):
    """Deterministic synthetic LM batch for a given step (resumable)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    toks = rng.choice(vocab, size=(batch, seq + 1), p=probs)
    # inject learnable bigram structure: even tokens followed by tok+1
    mask = (toks[:, :-1] % 2 == 0) & (rng.random((batch, seq)) < 0.7)
    shifted = np.minimum(toks[:, :-1] + 1, vocab - 1)
    toks[:, 1:] = np.where(mask, shifted, toks[:, 1:])
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}
