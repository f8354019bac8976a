"""Quickstart: privacy-preserving distributed LASSO on the port.

Port of ``examples/quickstart.py``.  A master node solves
``min 1/2||y - Ax||^2 + lam ||x||_1`` by renting compute from 3 edge
nodes that never see y, z, v or x in the clear: the paper's 3P-ADMM-PC2
with real Paillier encryption (256-bit demo key), its big-integer work on
the card.

Run:  python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import admm, protocol
from repro_torch.core.quantization import QuantSpec
from repro_torch.data.synthetic import make_lasso
from repro_torch.examples import parse_args


def main(argv=None) -> protocol.ProtocolResult:
    args = parse_args(__doc__, argv)
    # 1. a sparse recovery problem: 12-sparse x in R^48 from 24 measurements
    inst = make_lasso(M=24, N=48, sparsity=0.1, noise=0.01, seed=0)

    # 2. the three-phase private protocol (gold Paillier, 256-bit demo key)
    spec = QuantSpec(delta=1e6, zmin=-8.0, zmax=8.0)
    cfg = protocol.ProtocolConfig(K=3, rho=1.0, lam=0.05, iters=30,
                                  spec=spec, cipher="gold", key_bits=256,
                                  seed=0, device=args.device)
    result = protocol.run_protocol(inst.A, inst.y, cfg)

    # 3. against the unencrypted distributed solver (float64, host)
    x_ref, _ = admm.distributed_admm(inst.A, inst.y, cfg.K,
                                     admm.ADMMConfig(lam=0.05, iters=30))
    gap = float(np.max(np.abs(result.x - x_ref.numpy())))
    mse = float(np.mean((result.x - inst.x_true) ** 2))

    print(f"recovered x: MSE vs truth = {mse:.5f}")
    print(f"privacy cost: |x_private - x_plain| = {gap:.2e} "
          f"(pure quantization error)")
    print(f"crypto ops: {result.stats['ops']['iterate']}")
    print(f"traffic: {result.stats['traffic_bytes']}")
    assert gap < 1e-2
    print("OK")
    result.cfg, result.inst = cfg, inst
    return result


if __name__ == "__main__":
    main()
