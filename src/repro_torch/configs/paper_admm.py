"""The paper's own experiment configurations (§V)."""
import dataclasses

from ..core.admm import ADMMConfig
from ..core.quantization import QuantSpec


@dataclasses.dataclass(frozen=True)
class PaperSetup:
    M: int
    N: int
    K: int
    key_bits: int
    delta: float
    admm: ADMMConfig
    spec: QuantSpec


# Fig. 6 setup: A in R^{3000x27000}, K=3, 2048-bit keys, Delta=1e15
FIG6 = PaperSetup(M=3000, N=27000, K=3, key_bits=2048, delta=1e15,
                  admm=ADMMConfig(rho=1.0, lam=1.0, iters=100),
                  spec=QuantSpec(delta=1e15, zmin=-16, zmax=16))

# Fig. 7 setup: A in R^{10000x65536}, K in {3, 10}
FIG7 = PaperSetup(M=10000, N=65536, K=10, key_bits=2048, delta=1e15,
                  admm=ADMMConfig(rho=1.0, lam=1.0, iters=100),
                  spec=QuantSpec(delta=1e15, zmin=-16, zmax=16))


def scaled(setup: PaperSetup, factor: int) -> PaperSetup:
    """CPU-container scaling: divide dims by ``factor`` (EXPERIMENTS.md)."""
    return dataclasses.replace(setup, M=setup.M // factor,
                               N=setup.N // factor)
