"""Rounds of the port's gold LASSO main path, alone in one process.

``python3 scripts/torch_rounds.py`` on a machine with an NVIDIA card
builds the port's kernels (``src/repro_torch``) and runs the main path
of ``chip_smoke.py`` (2048-bit keys, Delta = 1e15, K = 3, M = 64) with
nothing else in the process: 3 rounds at N = 576, twice one round at
N = 1,152, then 3 rounds at N = 576 again, printing the share phase and
each round's seconds.  It checks nothing: ``chip_smoke.py`` holds the
same runs against the plain arm.  Run from two checkouts in turns on one
card, it compares their rounds without the other phases of
``chip_smoke.py`` before them.
"""
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import protocol  # noqa: E402
from repro_torch.core.quantization import QuantSpec  # noqa: E402
from repro_torch.data.synthetic import make_lasso  # noqa: E402
from repro_torch.kernels import build  # noqa: E402


def main():
    t0 = time.perf_counter()
    build.build_all()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    for n, iters in ((576, 3), (1152, 1), (1152, 1), (576, 3)):
        inst = make_lasso(64, n, sparsity=0.1, noise=0.01, seed=0)
        cfg = protocol.ProtocolConfig(
            K=3, rho=1.0, lam=1.0, iters=iters,
            spec=QuantSpec(delta=1e15, zmin=-16.0, zmax=16.0),
            cipher="gold", key_bits=2048, seed=0, device="cuda")
        secs = protocol.run_protocol(inst.A, inst.y, cfg).stats["seconds"]
        print(f"N={n}: share {secs['share']:.4f} s, rounds "
              + ", ".join(f"{r:.4f}" for r in secs["rounds"]), flush=True)


if __name__ == "__main__":
    main()
