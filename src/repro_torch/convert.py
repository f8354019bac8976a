"""Carry key material and limb state over from the reference package.

The system has no weights; what the two packages share is key material
and ciphertext state.  ``key_from_reference`` rebuilds a Paillier key
from the reference key's fields as Python ints (``dataclasses.asdict``
of a ``repro.core.paillier.PaillierKey``), and ``limbs_from_numpy`` turns
reference limb arrays (numpy int32 ``(B, L16)``, as ``bigint.from_ints``,
``ModulusPack`` and ``CipherTensor.limbs`` hold them) into port tensors.
Neither imports the reference: callers hand over plain data.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import resolve_device
from .core.paillier import PaillierKey


def key_from_reference(fields: dict) -> PaillierKey:
    """The port's key for the reference key's fields (Python ints)."""
    names = [f.name for f in dataclasses.fields(PaillierKey)]
    missing = [n for n in names if n not in fields]
    if missing:
        raise KeyError(f"reference key lacks fields {missing}")
    return PaillierKey(**{n: int(fields[n]) for n in names})


def limbs_from_numpy(arr, device=None) -> torch.Tensor:
    """Reference radix-2^16 limbs (int32, values < 2^16) as an int32
    tensor on ``device`` (default cuda)."""
    a = np.asarray(arr)
    if a.size and (a.min() < 0 or a.max() > 0xFFFF):
        raise ValueError("limb values must lie in [0, 2^16)")
    return torch.as_tensor(a.astype(np.int32), device=resolve_device(device))
