"""What the drivers share: the program's configuration from a cell's
configuration file, the inputs, the window's length in rounds and the
outcome a driver hands back.

Nothing here imports the program at module level: ``repro_torch`` loads
inside the functions, after the harness has set the run's environment.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from . import data


@dataclasses.dataclass
class Tenant:
    """One protocol instance of the window: its inputs and the iterates
    the program produced, one row a round."""
    A: np.ndarray
    y: np.ndarray
    history: np.ndarray


@dataclasses.dataclass
class Outcome:
    """What a driver's window produced."""
    tenants: list
    rounds: int                 # rounds each tenant was asked for
    laps: list                  # every tenant-round's wall lap, s
    window_s: float             # wall seconds of the window
    serve: dict | None = None   # the cross-tenant coalescer's counters
    counts: dict = dataclasses.field(default_factory=dict)  # steps, tokens
    payload: object = None      # what the driver's own judge reads


def inputs(config: dict, seed: int):
    """``(A, y)`` of the cell's configuration for one seed."""
    return data.lasso_inputs(config["M"], config["N"], seed,
                             sparsity=config["sparsity"],
                             noise=config["noise"])


def protocol_config(config: dict, *, seed: int, iters: int, device: str):
    """The program's ``ProtocolConfig`` for the configuration file."""
    from repro_torch.core import protocol
    from repro_torch.core.quantization import QuantSpec
    return protocol.ProtocolConfig(
        K=config["K"], rho=config["rho"], lam=config["lam"], iters=iters,
        spec=QuantSpec(delta=config["delta"], zmin=config["zmin"],
                       zmax=config["zmax"]),
        workload=config["workload"], cipher=config["cipher"],
        key_bits=config["key_bits"], crt=config["crt"],
        gold_batch=config["gold_batch"], seed=seed, device=device)


def window_rounds(seconds: float, round_s: float, least: int) -> int:
    """Rounds that fill ``seconds`` at the warm-up's ``round_s``."""
    return max(least, math.ceil(seconds / round_s))
