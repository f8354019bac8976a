"""repro_torch.workloads — registry of ADMM problem families.

Port of ``repro.workloads``: every family of the reference, registered
under the same name (``names()`` equals the reference's), so
``ProtocolConfig.workload`` resolves the same way in both packages.

>>> from repro_torch import workloads
>>> sorted(workloads.names())
['consensus_lasso', 'consensus_logistic', 'elastic_net', 'lasso', \
'logistic', 'power_grid', 'ridge', 'streaming_lasso']
"""
from __future__ import annotations

from .base import (Workload, WorkloadInstance, WorkloadState,  # noqa: F401
                   SecureAggContext, simulate_float)

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
from . import (lasso, ridge, elastic_net, logistic,  # noqa: E402,F401
               power_grid, consensus, streaming)
