"""Power-network reconstruction (paper §V-C) as a first-class workload.

Per-bus LASSO on the Kirchhoff observations S_i = Phi_i d_i (eq. 50),
where the recovered admittance vector's support is scored against the
true adjacency row (AUROC/AUPRC — the paper's Fig. 10 metric).  The ADMM
machinery is LASSO's; only data generation and metrics differ.

Copied from ``repro.workloads.power_grid`` (numpy only).
"""
from __future__ import annotations

import numpy as np

from ..data import synthetic
from . import register
from .base import WorkloadInstance
from .lasso import LassoWorkload


@register
class PowerGridWorkload(LassoWorkload):
    name = "power_grid"
    default_params = {"rho": 1.0, "lam": 0.1}

    def make_instance(self, M: int, N: int, K: int,
                      seed: int = 0, **kw) -> WorkloadInstance:
        """N buses, M voltage/current observation rows; the per-bus LASSO
        instance of ``bus`` (default 0).  All N buses are kept — the
        ragged column split pads internally, so the historical
        truncation to a multiple of K (which silently dropped buses
        from the reconstruction) is gone."""
        bus = int(kw.pop("bus", 0))
        net = synthetic.make_power_network(
            N, avg_degree=kw.pop("avg_degree", 3.0), T=M, seed=seed)
        inst = synthetic.bus_lasso(net, bus)
        truth = net.adjacency[bus].astype(bool)
        mask = np.ones(N, bool)
        mask[bus] = False                          # exclude the self column
        return WorkloadInstance(
            A=inst.A, y=inst.y, x_true=inst.x_true,
            meta={"bus": bus, "adjacency": truth, "mask": mask})

    def metrics(self, inst: WorkloadInstance, x: np.ndarray) -> dict:
        out = super().metrics(inst, x)
        x = np.asarray(x)[:inst.A.shape[1]]   # strip ragged-split padding
        mask = inst.meta.get("mask")
        truth = inst.meta.get("adjacency")
        if mask is not None and truth is not None:
            out["auroc"] = _auroc(truth[mask], np.abs(x)[mask])
        return out


def _auroc(y_true: np.ndarray, score: np.ndarray) -> float:
    """Rank-based AUROC (average ranks over ties)."""
    y = np.asarray(y_true).astype(bool).ravel()
    s = np.asarray(score).ravel()
    n_pos = int(y.sum())
    n_neg = y.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(s, kind="mergesort")
    ranks = np.empty(y.size, dtype=np.float64)
    ranks[order] = np.arange(1, y.size + 1)
    s_sorted = s[order]
    i = 0
    while i < y.size:                       # average ranks over ties
        j = i
        while j + 1 < y.size and s_sorted[j + 1] == s_sorted[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = (i + j) / 2.0 + 1.0
        i = j + 1
    return float((ranks[y].sum() - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))
