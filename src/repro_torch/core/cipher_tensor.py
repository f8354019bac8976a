"""Limb-resident Paillier ciphertext batches — the pipeline's on-device type.

Port of ``repro.core.cipher_tensor``: a batch of ciphertexts stays
resident on the device as a ``(B, L16(n^2))`` radix-2^16 int32 tensor
between protocol phases, and Python ints only exist when something needs
them (``to_ints`` is lazy and cached).  The int boundary is the phase
boundary, not the op boundary.

Also here: the two batched helpers the *edge* side of Algorithm 3 needs.
An edge holds only Remark-4 material (p^2, phi(p^2), g mod p^2 — never the
key), so these work from a bare modulus rather than a ``BatchKey``:

* :func:`modexp_mod_vec` — whole-batch fixed-base ModExp mod an arbitrary
  modulus (the collaborative-encryption half, ``g'^{O(m) mod phi(p^2)}``,
  and the master's unmask factors, with exponents up to the modulus'
  width);
* :func:`reduce_mod_vec` — ``x mod p^2`` over a ciphertext batch (the
  decryption assist), straight off the limbs of a :class:`CipherTensor`.

Both are bit-exact against the scalar ``pow``/``%`` loops they replace
and run on the limb kernels of ``device``.
"""
from __future__ import annotations

import functools
from typing import Sequence

import torch

from .. import resolve_device
from . import bigint as bi
from . import paillier_vec as pv
from ..kernels import ops

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


def concat(parts: Sequence[CipherTensor]) -> CipherTensor:
    """Concatenate ciphertext batches along the batch axis (limb space)."""
    if not parts:
        raise ValueError("concat of zero CipherTensors")
    ints = None
    if all(p.ints_materialized for p in parts):
        ints = [c for p in parts for c in p._ints]
    return CipherTensor(parts[0].bk,
                        torch.cat([p.limbs for p in parts], dim=0),
                        ints=ints)


# ---------------------------------------------------------------------------
# Bare-modulus batched helpers (Algorithm 3 edge side)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _pack(modulus: int) -> ops.ModulusPack:
    return ops.pack_modulus(modulus)


def modexp_mod_vec(base: int, exps: Sequence[int], modulus: int,
                   device=None) -> list[int]:
    """``[pow(base, e, modulus) for e in exps]`` as one batched launch on
    ``device`` (default the card).

    ``exps`` must be nonnegative (callers reduce mod the group order
    first, like the scalar loops this replaces).  The shared base is
    broadcast; exponent limbs size to the batch maximum.
    """
    exps = [int(e) for e in exps]
    if not exps:
        return []
    if any(e < 0 for e in exps):
        raise ValueError("modexp_mod_vec needs nonnegative exponents")
    dev = resolve_device(device)
    pack = _pack(int(modulus))
    le = max(1, max(bi.n_limbs_for(e) for e in exps))
    base_row = torch.as_tensor(
        bi.from_int(int(base) % pack.m_int, pack.L16), device=dev)
    bases = base_row.expand(len(exps), pack.L16)
    out = ops.modexp(bases, torch.as_tensor(bi.from_ints(exps, le),
                                            device=dev), pack)
    return bi.to_ints(out)


def reduce_mod_vec(cs, modulus: int, device=None) -> list[int]:
    """``[int(c) % modulus for c in cs]`` without per-element host division.

    A :class:`CipherTensor` is reduced straight off its resident limbs on
    their device (no materialization); any int sequence is bulk-packed
    onto ``device`` (default the card) first.
    """
    if isinstance(cs, CipherTensor):
        limbs = cs.limbs
    else:
        cs = [int(c) for c in cs]
        if not cs:
            return []
        width = max(1, max(bi.n_limbs_for(c) for c in cs))
        limbs = torch.as_tensor(bi.from_ints(cs, width),
                                device=resolve_device(device))
    if int(limbs.shape[0]) == 0:
        return []
    return bi.to_ints(pv._reduce_into(limbs, _pack(int(modulus))))
