"""The control of ``correct``: the plain reference put in the program's
place and computed a precision lower than the configuration states
(float32 for its float64 host arithmetic), judged as a run is judged.

    python3 portbench/control.py --cell fig6_k3_n1584.solo --rounds 22 \\
        --seeds 11 12 13

prints, for each seed, the verdict of the harness's own comparison
(``reference.admm.judge``) on the control's iterates: ``correct`` and the
numbers compared, the widest gap from the reference's iterates over every
tenant and round among them (a sound run reads 0, its limit).  The benchmark's
own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def control_verdict(config: dict, tenants: int, seed: int, rounds: int,
                    dtype=np.float32) -> dict:
    """The verdict of :func:`portbench.reference.admm.judge`, the
    comparison that decides a run's ``correct``, on the control's iterates
    for one seed: each tenant's history computed by the reference in
    ``dtype``."""
    from portbench.program import Outcome, Tenant, inputs
    from portbench.reference.admm import judge, lasso_history
    kw = dict(K=config["K"], rho=config["rho"], lam=config["lam"],
              delta=config["delta"], zmin=config["zmin"],
              zmax=config["zmax"], rounds=rounds)
    tens = []
    for i in range(tenants):
        A, y = inputs(config, seed + i)
        tens.append(Tenant(A, y, lasso_history(A, y, dtype=dtype, **kw)[0]))
    return judge(Outcome(tenants=tens, rounds=rounds, laps=[], window_s=0.0),
                 config)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cell", required=True)
    parser.add_argument("--rounds", type=int, required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import bench
    cell = bench.resolve_cell(args.cell)
    tenants = cell.traffic["params"].get("tenants", 1)
    for seed in args.seeds:
        verdict = control_verdict(cell.config, tenants, seed, args.rounds)
        print(json.dumps({"cell": args.cell, "seed": seed,
                          "rounds": args.rounds,
                          "correct": verdict["correct"],
                          "checks": verdict["checks"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
