"""Simulated edge network: stragglers, lossy links and a relay hierarchy.

Port of ``examples/edge_network_sim.py``.  It runs the same private LASSO
three ways on the event-driven runtime and prints what the deployment
choices cost:

  1. star topology, perfect links, synchronous barrier (the baseline);
  2. hierarchical (master -> relay -> edge) with jittery, lossy links:
     the same answer, a later virtual clock, retransmissions on the wire;
  3. star with one 10x straggler under a deadline: the master proceeds
     on stale blocks and still converges (Theorem-1 pairing keeps the
     dequantization sound).

The cipher is the reference's plain arm, so the run is host work on any
device.  After the reference's lines it prints ``OK``.

Run:  python -m repro_torch.examples.edge_network_sim [--device cpu]
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import protocol
from repro_torch.core.quantization import QuantSpec
from repro_torch.data.synthetic import make_lasso
from repro_torch.examples import parse_args
from repro_torch.runtime import LinkModel, hierarchical, star
from repro_torch.runtime.runner import run_on_runtime

K = 8


def main(argv=None) -> dict:
    args = parse_args(__doc__, argv)
    inst = make_lasso(M=32, N=64, sparsity=0.1, noise=0.01, seed=0)
    spec = QuantSpec(delta=1e6, zmin=-8.0, zmax=8.0)
    base = dict(K=K, lam=0.05, iters=20, spec=spec, cipher="plain", seed=0,
                device=args.device)

    def report(tag, r):
        rs = r.stats["runtime"]
        print(f"{tag:<26} mse={np.mean((r.x - inst.x_true) ** 2):.4f}  "
              f"virtual={rs['virtual_time']:.3f}s  stale={r.stale_events}  "
              f"retx={rs['retransmits']}")

    # 1. the baseline everyone else must match bit-for-bit
    cfg = protocol.ProtocolConfig(**base)
    r_star = run_on_runtime(inst.A, inst.y, cfg, topology=star(K))
    report("star/sync", r_star)

    # 2. relays + bad links: delayed, retransmitted, but never corrupted
    r_hier = run_on_runtime(
        inst.A, inst.y, cfg, topology=hierarchical(K, fanout=4),
        link=LinkModel(latency_s=2e-3, jitter_s=1e-3, drop_prob=0.05))
    report("hierarchical/lossy", r_hier)
    assert np.array_equal(r_star.history, r_hier.history)

    # 3. one straggler, deadline mode: stale blocks instead of waiting
    cfg_dl = protocol.ProtocolConfig(**base, deadline=0.5,
                                     latency_fn=lambda k, t:
                                     5.0 if (k == 3 and t % 2) else 0.05)
    r_dl = run_on_runtime(inst.A, inst.y, cfg_dl, topology=star(K))
    report("star/deadline+straggler", r_dl)
    assert r_dl.stale_events > 0
    print("OK")
    return {"star/sync": r_star, "hierarchical/lossy": r_hier,
            "star/deadline+straggler": r_dl}


if __name__ == "__main__":
    main()
