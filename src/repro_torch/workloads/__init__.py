"""repro_torch.workloads — registry of ADMM problem families.

Port of ``repro.workloads``.  This slice registers the paper's own family,
``lasso``; the other families (ridge, elastic_net, logistic, power_grid,
consensus, streaming) and secure aggregation arrive with a later slice.
"""
from __future__ import annotations

from .base import Workload, WorkloadInstance, WorkloadState  # noqa: F401

REGISTRY: dict[str, type[Workload]] = {}


def register(cls: type[Workload]) -> type[Workload]:
    """Class decorator: add a Workload subclass to the registry."""
    if not cls.name or cls.name == "base":
        raise ValueError(f"{cls.__name__} needs a unique .name")
    REGISTRY[cls.name] = cls
    return cls


def get(name: str, **params) -> Workload:
    """Instantiate the named workload (``params`` forward to __init__)."""
    try:
        cls = REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown workload {name!r}; registered: "
                       f"{sorted(REGISTRY)}") from None
    return cls(**params)


def get_default(name: str) -> Workload:
    """Instantiate the named workload with its class-recommended params."""
    try:
        cls = REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown workload {name!r}; registered: "
                       f"{sorted(REGISTRY)}") from None
    return cls(**cls.default_params)


def names() -> list[str]:
    return sorted(REGISTRY)


# importing the family modules self-registers them
from . import lasso  # noqa: E402,F401
