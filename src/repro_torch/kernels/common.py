"""Shared pieces of the limb kernels' plain PyTorch versions.

The reference held big integers inside its kernels as radix-256 limbs
because the TPU vector unit has no 64-bit integer path
(``repro/kernels/common.py:3-9``).  That does not hold on Hopper: the
CUDA kernels (``csrc/``) work on 32-bit words with 64-bit products, and
the plain versions here work on the public radix-2^16 limbs with int64
accumulation (``core/bigint.py``).  Every function computes canonical
residues, so all of them agree with the reference's outputs exactly.

The ladders mirror the reference's schedules (``common.modexp2d``,
``modexp2d_win4``, ``montgomery.modexp2d_mont_fixed``) over any modular
multiply ``mul(a, b)``; the plain versions pick Barrett or Montgomery.
They are the CPU path and the on-card yardstick of the kernels, not the
constant-time artifact: the window select here indexes the table, where
the CUDA ``modexp`` kernel selects by an oblivious masked sum.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch
import torch.utils.weak

from ..core import bigint as bi
from ..obs import trace

MulFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DeviceModulus:
    """One modulus's material on one device, int32 radix-2^16 limbs.

    ``L16`` limbs hold m; the CUDA kernels work on ``L32 = ceil(L16/2)``
    32-bit words and the padded width ``W = 2 L32`` limbs.

    * ``m16`` (L16,), ``mu16`` (L16+1,) = floor(2^{32 L16} / m): Barrett
      of the plain versions (the reference's ``ModulusPack.m16/mu16``);
    * ``mw`` (W,) = m, ``muw`` (W+2,) = floor(2^{64 L32} / m): Barrett
      inside the kernels;
    * ``minv`` (W,) = -m^{-1} mod R, ``r1`` = R mod m, ``r2`` = R^2 mod m
      (W,) with R = 2^{32 L32}, and ``mp`` = -m^{-1} mod 2^32 (an int; a
      :class:`RowsModulus` table holds one int32 per modulus): Montgomery,
      ``None`` for even moduli.
    """
    L16: int
    L32: int
    m16: torch.Tensor
    mu16: torch.Tensor
    mw: torch.Tensor
    muw: torch.Tensor
    mp: int | torch.Tensor | None
    minv: torch.Tensor | None
    r1: torch.Tensor | None
    r2: torch.Tensor | None

    @property
    def W(self) -> int:
        return 2 * self.L32


def one_like(x: torch.Tensor) -> torch.Tensor:
    """The integer 1 in ``x``'s limb layout."""
    one = torch.zeros_like(x)
    one[..., 0] = 1
    return one


def exp_bit(exp64: torch.Tensor, j: int) -> torch.Tensor:
    """Bit j of each row's exponent, (B, Le) radix-2^16 -> (B,)."""
    return (exp64[:, j // bi.LIMB_BITS] >> (j % bi.LIMB_BITS)) & 1


def exp_window(exp64: torch.Tensor, j: int) -> torch.Tensor:
    """4-bit window j (bits 4j..4j+3) of each row's exponent -> (B,)."""
    return (exp64[:, (4 * j) // bi.LIMB_BITS] >> ((4 * j) % bi.LIMB_BITS)) & 0xF


def power_table(mul: MulFn, one: torch.Tensor,
                base: torch.Tensor) -> torch.Tensor:
    """(16, B, L): base^t for t = 0..15 (14 sequential products)."""
    tab = [one, base]
    for _ in range(2, 16):
        tab.append(mul(tab[-1], base))
    return torch.stack(tab)


def ladder_binary(mul: MulFn, one: torch.Tensor, base: torch.Tensor,
                  exp: torch.Tensor) -> torch.Tensor:
    """Right-to-left square-and-multiply over every exponent bit
    (``common.modexp2d``'s schedule: 2 products per bit)."""
    exp64 = exp.to(torch.int64)
    res, b = one, base
    for j in range(exp.shape[1] * bi.LIMB_BITS):
        bit = exp_bit(exp64, j)[:, None]
        res = torch.where(bit == 1, mul(res, b), res)
        b = mul(b, b)
    return res


def ladder_win4(mul: MulFn, one: torch.Tensor, base: torch.Tensor,
                exp: torch.Tensor) -> torch.Tensor:
    """MSB-first 4-bit windows: 4 squarings and one table product per
    window (``common.modexp2d_win4``'s schedule)."""
    exp64 = exp.to(torch.int64)
    table = power_table(mul, one, base)
    rows = torch.arange(base.shape[0], device=base.device)
    n_win = exp.shape[1] * bi.LIMB_BITS // 4
    res = one
    for w in range(n_win):
        for _ in range(4):
            res = mul(res, res)
        res = mul(res, table[exp_window(exp64, n_win - 1 - w), rows])
    return res


def ladder_fixed(mul: MulFn, one: torch.Tensor, base: torch.Tensor,
                 windows: Sequence[int]) -> torch.Tensor:
    """One host-known exponent for the whole batch, as its MSB-first
    4-bit windows; an empty schedule (e = 0) gives 1."""
    if not windows:
        return one
    table = power_table(mul, one, base)
    res = one
    for win in windows:
        for _ in range(4):
            res = mul(res, res)
        res = mul(res, table[win])
    return res


def barrett_mulmod(a: torch.Tensor, b: torch.Tensor,
                   dm: DeviceModulus) -> torch.Tensor:
    """int64 (a*b) mod m for any a, b < 2^{16 L16} (Barrett is exact for
    a*b < B^{2 L16})."""
    return bi._barrett(bi._mul(a, b), dm.m16, dm.mu16)


def barrett_ladder(ladder, base: torch.Tensor, arg,
                   dm: DeviceModulus) -> torch.Tensor:
    """Run ``ladder`` over Barrett products (the base is reduced first);
    (B, L16) -> (B, L16) int32."""
    base_r = bi._barrett(base, dm.m16, dm.mu16)
    return ladder(lambda a, b: barrett_mulmod(a, b, dm), one_like(base_r),
                  base_r, arg).to(torch.int32)


#: the range of every row index read on the host: the index tensor ->
#: (its version counter then, least entry, greatest entry), or None for
#: an empty index.  Entries leave with their tensors.
_INDEX_RANGES = torch.utils.weak.WeakTensorKeyDictionary()


def note_index_range(midx: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Record that ``midx``'s entries lie in [lo, hi], known on the host
    where it was built; returns ``midx``."""
    _INDEX_RANGES[midx] = (midx._version, lo, hi)
    return midx


def _noted(midx: torch.Tensor) -> tuple | None:
    """The noted range of ``midx``, None when there is none or the tensor
    was written in place since (its version counter moved)."""
    noted = _INDEX_RANGES.get(midx)
    return noted if noted is not None and noted[0] == midx._version \
        else None


def index_range(midx: torch.Tensor) -> tuple[int, int] | None:
    """(least, greatest) entry of a row index whose range was noted, None
    when it is empty.  Raises ``ValueError`` when no range was noted or
    the tensor was written in place since: nothing here reads the index,
    so nothing here waits for the device."""
    noted = _noted(midx)
    if noted is None:
        raise ValueError("row index of no known range (built other than by "
                         "RowsModulus, or written in place since)")
    return None if noted[1] > noted[2] else noted[1:]


@dataclasses.dataclass(frozen=True)
class RowsModulus:
    """Per-row moduli of one launch: a table of T moduli of one width on
    one device, and each row's index into it (the serving path's
    cross-tenant launches, one tenant key per row).

    ``table`` holds the material of :class:`DeviceModulus` with a leading
    T axis: Barrett's ``m16`` (T, L16), ``mu16`` (T, L16+1) for the plain
    versions, ``mw`` (T, W), ``muw`` (T, W+2) for the kernels, and
    Montgomery's ``mp`` (T,) int32 (-m^{-1} mod 2^32, as a two's
    complement), ``minv``, ``r1``, ``r2`` (T, W), all four ``None`` when
    any table modulus is even.  ``midx`` is (B,) int32, every entry in
    [0, T); ``moduli`` are the T moduli as ints.

    The kernels read table rows at ``midx`` unchecked, so its range is
    known on the host (:func:`index_range`) for the launch wrappers to
    check without reading the index back: ``ops.rows_modulus`` notes it
    from the host ints it builds the index from, :meth:`repeat` carries
    it over, and an index built any other way is read on the host once,
    here (a device sync when it lies on a card).
    """
    table: DeviceModulus
    midx: torch.Tensor
    moduli: tuple

    def __post_init__(self):
        idx = self.midx
        if _noted(idx) is None:
            host = idx.detach()
            if host.is_cuda:
                with trace.wait("wait.rows_modulus"):
                    host = host.cpu()
            lo, hi = (int(host.min()), int(host.max())) if host.numel() \
                else (0, -1)
            note_index_range(idx, lo, hi)

    @property
    def B(self) -> int:
        return int(self.midx.shape[0])

    @property
    def montgomery(self) -> bool:
        """Whether the table has Montgomery material (every modulus odd)."""
        return self.table.mp is not None

    def repeat(self, repeats) -> "RowsModulus":
        """Each row ``repeats`` times in a row (an int, or one count per
        row), as ``torch.repeat_interleave``: the same table.  The counts
        are host ints, so the output size is known here and the range of
        the new index is the old one's (rows repeated 0 times only drop
        entries): nothing waits for the device."""
        midx = self.midx
        if isinstance(repeats, int):
            out = torch.repeat_interleave(midx, repeats)
        else:
            counts = [int(c) for c in repeats]
            if min(counts, default=0) < 0 or len(counts) != self.B:
                raise ValueError(f"repeat: {len(counts)} non-negative "
                                 f"counts for {self.B} rows, got {counts}")
            out = torch.repeat_interleave(
                midx, bi.to_device(np.asarray(counts, np.int64),
                                   midx.device), output_size=sum(counts))
        span = index_range(midx) if out.numel() else None
        note_index_range(out, *(span or (0, -1)))
        return RowsModulus(self.table, out, self.moduli)

    def per_row(self) -> DeviceModulus:
        """Row i's modulus in row i of every table tensor (B rows): the
        plain versions' Barrett and REDC broadcast over them."""
        idx = self.midx.long()
        t = self.table
        return dataclasses.replace(t, **{
            f.name: getattr(t, f.name)[idx]
            for f in dataclasses.fields(t)
            if isinstance(getattr(t, f.name), torch.Tensor)})
