"""ADMM configuration and the LASSO shrinkage operator.

Port of the part of ``repro.core.admm`` the protocol's main path uses;
float64 on the host, as in the reference (which relied on JAX x64).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ADMMConfig:
    rho: float = 1.0
    lam: float = 1.0
    iters: int = 100
    y_scale: str = "consistent"   # "consistent" (y/K) | "paper" (y)
    coupled: bool = False         # beyond-paper consensus coupling


def soft_threshold(x: torch.Tensor, t: float) -> torch.Tensor:
    """S_t(x) = sign(x) max(|x| - t, 0) (eq. 4b's shrinkage operator)."""
    return torch.sign(x) * torch.clamp(torch.abs(x) - t, min=0.0)
