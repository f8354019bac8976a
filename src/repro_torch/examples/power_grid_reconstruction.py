"""Power-network topology reconstruction (paper §V-C, Fig. 10).

Port of ``examples/power_grid_reconstruction.py``.  It recovers which
buses are connected from voltage/current observations by solving one
LASSO per bus with the distributed private protocol, then scores
AUROC/AUPRC against the ground-truth adjacency.  ``auroc``/``auprc`` are
the port's own copies of the reference's benchmark helpers.

Run:  python -m repro_torch.examples.power_grid_reconstruction [--device cpu]
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import protocol
from repro_torch.core.quantization import QuantSpec
from repro_torch.data import synthetic
from repro_torch.examples import parse_args


def auroc(y_true: np.ndarray, score: np.ndarray) -> float:
    """Rank-based AUROC (no sklearn)."""
    y = np.asarray(y_true).astype(bool).ravel()
    s = np.asarray(score).ravel()
    n_pos = int(y.sum())
    n_neg = y.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(s, kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, y.size + 1)
    # average ranks for ties
    s_sorted = s[order]
    i = 0
    while i < y.size:
        j = i
        while j + 1 < y.size and s_sorted[j + 1] == s_sorted[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = (i + j) / 2.0 + 1.0
        i = j + 1
    return float((ranks[y].sum() - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))


def auprc(y_true: np.ndarray, score: np.ndarray) -> float:
    """Area under precision-recall via step integration."""
    y = np.asarray(y_true).astype(bool).ravel()
    s = np.asarray(score).ravel()
    n_pos = int(y.sum())
    if n_pos == 0:
        return float("nan")
    order = np.argsort(-s, kind="mergesort")
    tp = np.cumsum(y[order])
    fp = np.cumsum(~y[order])
    precision = tp / (tp + fp)
    recall = tp / n_pos
    # step-wise integral (interpolated AP)
    ap = 0.0
    prev_r = 0.0
    for p, r in zip(precision, recall):
        if r > prev_r:
            ap += p * (r - prev_r)
            prev_r = r
    return float(ap)


def main(argv=None) -> dict:
    args = parse_args(__doc__, argv)
    net = synthetic.make_power_network(n_bus=48, avg_degree=3.0, T=160,
                                       seed=0)
    spec = QuantSpec(delta=1e6, zmin=-64.0, zmax=64.0)

    scores, labels = [], []
    buses = range(0, 48, 6)
    for bus in buses:
        inst = synthetic.bus_lasso(net, bus)
        Npad = inst.A.shape[1] - (inst.A.shape[1] % 4)
        cfg = protocol.ProtocolConfig(K=4, lam=0.1, iters=60, spec=spec,
                                      cipher="plain", seed=0,
                                      device=args.device)
        r = protocol.run_protocol(inst.A[:, :Npad], inst.y, cfg)
        mask = np.ones(Npad, bool)
        mask[bus] = False
        scores.append(np.abs(r.x)[mask])
        labels.append(net.adjacency[bus][:Npad].astype(bool)[mask])

    s = np.concatenate(scores)
    lab = np.concatenate(labels)
    print(f"buses evaluated: {len(list(buses))}")
    print(f"AUROC = {auroc(lab, s):.4f}   AUPRC = {auprc(lab, s):.4f}")
    assert auroc(lab, s) > 0.9, "reconstruction should be near-perfect"
    print("OK")
    return {"auroc": auroc(lab, s), "auprc": auprc(lab, s), "scores": s}


if __name__ == "__main__":
    main()
