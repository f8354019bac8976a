"""Limb-resident Paillier ciphertext batches — the pipeline's on-device type.

Port of ``repro.core.cipher_tensor``: a batch of ciphertexts stays
resident on the device as a ``(B, L16(n^2))`` radix-2^16 int32 tensor
between protocol phases, and Python ints only exist when something needs
them (``to_ints`` is lazy and cached).  The int boundary is the phase
boundary, not the op boundary.  (The Algorithm-3 edge helpers
``modexp_mod_vec``/``reduce_mod_vec`` arrive with collaborative mode.)
"""
from __future__ import annotations

from typing import Sequence

import torch

from . import bigint as bi

# host<->limb conversion telemetry: bumped by CipherTensor only, so tests
# can assert the resident pipeline converts once per phase boundary
CONVERSIONS = {"to_ints": 0, "from_ints": 0}


def reset_conversion_stats() -> dict:
    """Zero the conversion counters, returning the previous values."""
    prev = dict(CONVERSIONS)
    CONVERSIONS["to_ints"] = CONVERSIONS["from_ints"] = 0
    return prev


class CipherTensor:
    """A batch of ciphertexts mod n^2, resident in limb form.

    ``limbs`` is a ``(B, L16(n^2))`` int32 tensor on ``bk.device``;
    ``bk`` is the :class:`paillier_batch.BatchKey`.  ``to_ints()``
    materializes Python ints lazily and caches them; iteration, indexing
    and ``==`` against int lists work on the materialized view.
    """

    __slots__ = ("bk", "limbs", "_ints")

    def __init__(self, bk, limbs: torch.Tensor, ints: list[int] | None = None):
        self.bk = bk
        self.limbs = limbs
        self._ints = list(ints) if ints is not None else None

    @classmethod
    def from_ints(cls, bk, ints: Sequence[int]) -> "CipherTensor":
        """Pack Python-int ciphertexts into limb form (one bulk encode)."""
        ints = [int(c) for c in ints]
        CONVERSIONS["from_ints"] += 1
        limbs = torch.as_tensor(bi.from_ints(ints, bk.vk.pack_n2.L16),
                                device=bk.device)
        return cls(bk, limbs, ints=ints)

    @property
    def shape(self) -> tuple:
        return tuple(self.limbs.shape)

    def __len__(self) -> int:
        return int(self.limbs.shape[0])

    @property
    def ints_materialized(self) -> bool:
        return self._ints is not None

    def to_ints(self) -> list[int]:
        """Materialize (and cache) the batch as Python ints."""
        if self._ints is None:
            CONVERSIONS["to_ints"] += 1
            self._ints = bi.to_ints(self.limbs)
        return self._ints

    def __iter__(self):
        return iter(self.to_ints())

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return CipherTensor(
                self.bk, self.limbs[idx],
                ints=None if self._ints is None else self._ints[idx])
        return self.to_ints()[idx]

    def __eq__(self, other) -> bool:
        if isinstance(other, CipherTensor):
            other = other.to_ints()
        if isinstance(other, (list, tuple)):
            return self.to_ints() == list(other)
        return NotImplemented

    __hash__ = None  # mutable cache; equality is by ciphertext value

    def __repr__(self) -> str:
        state = "materialized" if self._ints is not None else "resident"
        return (f"CipherTensor(B={len(self)}, "
                f"L16={int(self.limbs.shape[-1])}, {state})")

