"""Workload zoo: every registered ADMM family through the privacy protocol.

Port of ``examples/workload_zoo.py``.  One pass over
``repro_torch.workloads``: lasso, ridge, elastic_net, logistic,
power_grid, the row-split consensus families (consensus_lasso /
consensus_logistic: every edge keeps its own rows, the aggregate crosses
through secure aggregation) and streaming_lasso (time-varying y through
the re-share hook), each end to end through 3P-ADMM-PC2 with real
Paillier encryption (batched gold arm, small demo key) against its
plaintext distributed float baseline and its convergence reference.

Run:  python -m repro_torch.examples.workload_zoo [--device cpu]
"""
from __future__ import annotations

import numpy as np

from repro_torch import workloads
from repro_torch.core import protocol
from repro_torch.examples import parse_args
from repro_torch.workloads.base import simulate_float

M, N, K, ITERS = 48, 32, 4, 30

HEADER = (f"{'workload':<12} {'obj(private)':>13} {'obj(float)':>11} "
          f"{'|x_priv - x_float|':>18} {'|x_float - ref|':>15}  metrics")


def run_family(name: str, iters: int = ITERS, device=None) -> dict:
    """One family's row: the private run, its float baseline and
    reference, and the printed line (``line``)."""
    wl = workloads.get_default(name)
    inst = wl.make_instance(M, N, K, seed=0)
    # quantization range calibrated from the data (Theorem-1 contract)
    spec = wl.calibrate_spec(inst.A, inst.y, K, iters)
    cfg = protocol.ProtocolConfig(K=K, rho=wl.rho, lam=wl.lam, iters=iters,
                                  spec=spec, cipher="gold", key_bits=256,
                                  seed=0, workload=name, device=device)
    r = protocol.run_protocol(inst.A, inst.y, cfg, workload=wl)
    xf, _ = simulate_float(wl, inst.A, inst.y, K, iters)
    ref = wl.reference_solution(inst.A, inst.y, K)
    gap_q = float(np.max(np.abs(r.x - xf)))          # quantization only
    # row-split consensus states stack K copies: fold before comparing
    # against the N-dimensional reference
    gap_c = float(np.max(np.abs(wl.fold_solution(xf, K) - ref)))
    mets = {k: round(v, 4) for k, v in wl.metrics(inst, r.x).items()
            if k != "objective"}
    line = (f"{name:<12} {wl.objective(inst.A, inst.y, r.x):>13.5f} "
            f"{wl.objective(inst.A, inst.y, xf):>11.5f} {gap_q:>18.2e} "
            f"{gap_c:>15.2e}  {mets}")
    return {"name": name, "result": r, "cfg": cfg, "workload": wl,
            "inst": inst, "gap_q": gap_q, "gap_c": gap_c, "line": line}


def main(argv=None) -> list[dict]:
    args = parse_args(__doc__, argv)
    print(HEADER)
    rows = []
    for name in workloads.names():   # registry-driven: new families ride in
        row = run_family(name, device=args.device)
        print(row["line"])
        assert row["gap_q"] < 1e-2, (name, row["gap_q"])
        rows.append(row)
    print("OK — every family ran privately, within quantization error of "
          "its plaintext baseline")
    return rows


if __name__ == "__main__":
    main()
