"""Public wrappers over the limb kernels.

Port of ``repro.kernels.ops`` (``ModulusPack`` and the ``mulmod``,
``modexp`` and ``modexp_fixed`` wrappers).  Callers hold big integers as
radix-2^16 int32 limb tensors ``(B, L16)`` (``core/bigint.py``); the
wrappers pack the modulus, check the operands and hand them to the
kernel modules, which launch the CUDA kernel for a CUDA tensor and run
the plain PyTorch version for a CPU tensor.  There is no backend knob.

Reduction (``REPRO_REDUCE_IMPL``, read per call, the reference's meaning):
``montgomery`` (default) runs the REDC ladders for ``modexp`` and
``modexp_fixed`` on odd moduli (even moduli fall back to Barrett);
``barrett`` runs Barrett throughout.  Standalone ``mulmod`` is always
Barrett.  ``REPRO_MODEXP_METHOD`` (read at import, as in the reference)
picks the per-element ladder: ``win4`` (default) or ``binary``.

The rows layer (:func:`rows_modulus`, :func:`mulmod_rows`,
:func:`modexp_rows`, :func:`prod_rows`) takes one modulus per row, each a
tenant's n^2 in the serving path's cross-tenant launches; ``modexp_rows``
follows ``REPRO_REDUCE_IMPL`` as ``modexp`` does (Montgomery by default,
Barrett for a table with an even modulus); ``mulmod_rows`` follows the
moduli only (Montgomery when every one is odd, else Barrett), as
``prod_rows`` does.  :func:`prod_mod` is ``prod_rows`` under one
modulus (the matvec's product tree, ``paillier_vec.mul_tree``): both run
one ``csrc/prodtree.cu`` launch a product (``kernels/prodtree.py``),
Montgomery when every modulus is odd and Barrett otherwise, whatever
``REPRO_REDUCE_IMPL`` says (the reference's tree never reads it).  Its public
layout is the port's (B, L16) radix-2^16 int32 on the device, not the
reference's radix-256 numpy rows; the reference pads batches and
exponent widths to powers of two only to bound JAX retraces, and the
port does not.

Operands are never cut to the modulus width: an operand wider than L16
limbs raises.  (The reference cuts operands to the modulus' byte length,
``ops.py:126-130``, which loses the top byte of a full-width operand when
the modulus has an odd byte length.)
"""
from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import torch

from .. import resolve_device
from ..core import bigint as bi
from . import common as cm
from . import montgomery as mg
from .limb_mulmod import mulmod_limbs, mulmod_rows_limbs
from .modexp import (METHODS, REDUCE_IMPLS, modexp_fixed_limbs,
                     modexp_fixed_pair_limbs, modexp_limbs,
                     modexp_rows_limbs)
from .prodtree import prod_rows_limbs


@dataclasses.dataclass(frozen=True)
class ModulusPack:
    """Precomputed modulus material.

    The reference's fields, array for array: ``m16``/``mu16`` (radix
    2^16 Barrett), ``m8``/``mu8`` and the radix-256 Montgomery constants
    ``mp8``/``r1_8``/``r2_8`` (``None`` for even moduli).  The port's own:
    ``L32`` 32-bit words, ``muw`` = floor(2^{64 L32}/m), and with
    R = 2^{32 L32}: ``mp32`` = -m^{-1} mod 2^32, ``minv`` = -m^{-1} mod R,
    ``r1``/``r2`` = R, R^2 mod m (radix-2^16 limbs, width W = 2 L32).
    """
    m_int: int
    L16: int
    L8: int
    m16: np.ndarray    # (L16,)
    mu16: np.ndarray   # (L16+1,)  floor(2^{32 L16} / m)
    m8: np.ndarray     # (1, L8)
    mu8: np.ndarray    # (1, L8+1) floor(256^{2 L8} / m)
    mp8: int | None
    r1_8: np.ndarray | None    # (1, L8)
    r2_8: np.ndarray | None    # (1, L8)
    L32: int
    muw: np.ndarray            # (W+2,)
    mp32: int | None
    minv: np.ndarray | None    # (W,)
    r1: np.ndarray | None      # (W,)
    r2: np.ndarray | None      # (W,)
    _dev: dict = dataclasses.field(default_factory=dict, repr=False,
                                   compare=False)

    def on(self, device) -> cm.DeviceModulus:
        """This modulus's tensors on ``device`` (built once per device)."""
        dev = torch.device(device)
        dm = self._dev.get(str(dev))
        if dm is None:
            W = 2 * self.L32

            def t(arr):
                return None if arr is None else torch.as_tensor(
                    np.asarray(arr, np.int32), device=dev)

            dm = self._dev[str(dev)] = cm.DeviceModulus(
                L16=self.L16, L32=self.L32, m16=t(self.m16),
                mu16=t(self.mu16), mw=t(bi.from_int(self.m_int, W)),
                muw=t(self.muw), mp=self.mp32, minv=t(self.minv),
                r1=t(self.r1), r2=t(self.r2))
        return dm


def pack_modulus(m: int) -> ModulusPack:
    L8 = max(1, -(-m.bit_length() // 8))
    L16 = max(1, -(-m.bit_length() // 16))
    mu8 = (1 << (16 * L8)) // m  # 256^{2 L8} = 2^{16 L8}
    mu8_limbs = np.zeros(L8 + 1, np.int32)
    x = mu8
    for i in range(L8 + 1):
        mu8_limbs[i] = x & 0xFF
        x >>= 8
    assert x == 0
    mont8 = mg.mont_constants(m, L8)
    mp8 = r1_8 = r2_8 = None
    if mont8 is not None:
        mp8, r1, r2 = mont8
        r1_8 = _to8(r1, L8)[None, :]
        r2_8 = _to8(r2, L8)[None, :]
    L32 = -(-L16 // 2)
    W = 2 * L32
    mont32 = mg.mont_constants(m, L32, limb_bits=32)
    mp32 = minv = r1_w = r2_w = None
    if mont32 is not None:
        mp32, r1, r2 = mont32
        R = 1 << (32 * L32)
        minv = bi.from_int((-pow(m, -1, R)) % R, W)
        r1_w, r2_w = bi.from_int(r1, W), bi.from_int(r2, W)
    return ModulusPack(
        m_int=m, L16=L16, L8=L8,
        m16=bi.from_int(m, L16), mu16=bi.barrett_mu(m, L16),
        m8=_to8(m, L8)[None, :], mu8=mu8_limbs[None, :],
        mp8=mp8, r1_8=r1_8, r2_8=r2_8,
        L32=L32, muw=bi.from_int((1 << (64 * L32)) // m, W + 2),
        mp32=mp32, minv=minv, r1=r1_w, r2=r2_w,
    )


def _to8(x: int, n: int) -> np.ndarray:
    out = np.zeros(n, np.int32)
    for i in range(n):
        out[i] = x & 0xFF
        x >>= 8
    if x:
        raise ValueError("value does not fit limb count")
    return out


def active_reduce_impl() -> str:
    """The session-wide reduction knob, validated (read per call)."""
    impl = os.environ.get("REPRO_REDUCE_IMPL", "montgomery")
    if impl not in REDUCE_IMPLS:
        raise ValueError(f"REPRO_REDUCE_IMPL={impl!r}; expected one of "
                         f"{REDUCE_IMPLS}")
    return impl


def _resolve_reduce(odd: bool, reduce_impl: str | None) -> str:
    """``reduce_impl`` or the knob, validated; Barrett unless every
    modulus of the launch is ``odd`` (REDC needs m odd)."""
    impl = reduce_impl or active_reduce_impl()
    if impl not in REDUCE_IMPLS:
        raise ValueError(f"unknown reduce_impl {impl!r}; expected one of "
                         f"{REDUCE_IMPLS}")
    return impl if odd else "barrett"


def _operand(x, L16: int, device) -> torch.Tensor:
    """A (B, <=L16) limb array as a tensor of exactly L16 limbs; numpy
    input goes to ``device`` (default cuda), tensors stay where they are."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x), device=resolve_device(device))
    if x.ndim != 2:
        raise ValueError(f"expected a (B, L) limb array, got shape "
                         f"{tuple(x.shape)}")
    if x.shape[1] > L16:
        raise ValueError(f"operand has {x.shape[1]} limbs, wider than the "
                         f"modulus' {L16}; operands are never cut")
    return bi.fit(x, L16)


def _same_device(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if x.device != like.device:
        raise ValueError(f"operands on {x.device} and {like.device}")
    return x


def mulmod(a16, b16, pack: ModulusPack, device=None) -> torch.Tensor:
    """(B, L16) x (B, L16) -> (B, L16): (a*b) mod m, exact for any
    operands below 2^{16 L16}."""
    a = _operand(a16, pack.L16, device)
    b = _same_device(_operand(b16, pack.L16, a.device), a)
    if a.shape[0] == 0:
        return torch.zeros((0, pack.L16), dtype=torch.int32, device=a.device)
    return mulmod_limbs(a, b.expand_as(a), pack.on(a.device))


MODEXP_METHOD = os.environ.get("REPRO_MODEXP_METHOD", "win4")


def _validate_method(method: str, exp_bits: int) -> None:
    if method not in METHODS:
        raise ValueError(f"unknown modexp method {method!r}; expected one "
                         f"of {METHODS}")
    if method == "win4" and exp_bits % 4 != 0:
        raise ValueError(
            f"win4 modexp requires an exponent bit-width that is a "
            f"multiple of 4, got {exp_bits} bits; pad the exponent limbs "
            f"or use method='binary'")


def modexp(base16, exp16, pack: ModulusPack, device=None,
           method: str | None = None,
           reduce_impl: str | None = None) -> torch.Tensor:
    """base^exp mod m over a batch; per-element exponents ``(B, Le16)``.

    ``method``: "binary" (the paper's Algorithm-2 ladder) or "win4"
    (4-bit fixed window; default).  ``reduce_impl`` overrides
    ``REPRO_REDUCE_IMPL``.
    """
    method = method or MODEXP_METHOD
    _validate_method(method, np.shape(exp16)[1] * bi.LIMB_BITS)
    impl = _resolve_reduce(pack.mp32 is not None, reduce_impl)
    base = _operand(base16, pack.L16, device)
    if base.shape[0] == 0:
        return torch.zeros((0, pack.L16), dtype=torch.int32,
                           device=base.device)
    exp = exp16 if isinstance(exp16, torch.Tensor) else torch.as_tensor(
        np.asarray(exp16), device=base.device)
    return modexp_limbs(base, _same_device(exp, base), pack.on(base.device),
                        method, impl)


def modexp_fixed(base16, e: int, pack: ModulusPack, device=None,
                 reduce_impl: str | None = None) -> torch.Tensor:
    """base^e mod m with ONE host-known exponent shared across the batch
    (enc's ``r^n``, dec's ``c^lam`` halves).  The MSB-first 4-bit window
    schedule (:func:`montgomery.exp_windows`) goes to the kernel at run
    time, so no compile is keyed on ``e``."""
    if e < 0:
        raise ValueError("modexp_fixed requires a non-negative exponent; "
                         "invert the base host-side first")
    impl = _resolve_reduce(pack.mp32 is not None, reduce_impl)
    base = _operand(base16, pack.L16, device)
    if base.shape[0] == 0:
        return torch.zeros((0, pack.L16), dtype=torch.int32,
                           device=base.device)
    return modexp_fixed_limbs(base, mg.exp_windows(e), pack.on(base.device),
                              impl)


def modexp_fixed_pair(bases, exps, packs, device=None,
                      reduce_impl: str | None = None) -> tuple:
    """:func:`modexp_fixed` over the two CRT halves of a Paillier
    exponentiation: ``(bases[0]^exps[0] mod packs[0].m_int,
    bases[1]^exps[1] mod packs[1].m_int)``.  On the card both halves share
    one kernel launch when they run Montgomery at one width; the results
    equal two :func:`modexp_fixed` calls."""
    if min(exps) < 0:
        raise ValueError("modexp_fixed requires a non-negative exponent; "
                         "invert the base host-side first")
    impls = tuple(_resolve_reduce(p.mp32 is not None, reduce_impl)
                  for p in packs)
    bp = _operand(bases[0], packs[0].L16, device)
    bq = _same_device(_operand(bases[1], packs[1].L16, bp.device), bp)
    return modexp_fixed_pair_limbs(
        (bp, bq), tuple(mg.exp_windows(e) for e in exps),
        tuple(p.on(bp.device) for p in packs), impls)


# ---------------------------------------------------------------------------
# Rows layer: one modulus per row (the serving path's cross-tenant launches)
# ---------------------------------------------------------------------------

def _check_row_modulus(m: int, L8: int) -> None:
    if m >> (8 * L8):
        raise OverflowError(f"modulus of {(m.bit_length() + 7) // 8} bytes "
                            f"is wider than {L8}")
    if (m >> (8 * (L8 - 1))) == 0:
        raise ValueError(
            f"modulus does not fill {L8} radix-256 limbs (Barrett needs "
            "the top limb populated); cluster by exact byte length")


@functools.lru_cache(maxsize=64)
def _rows_table(moduli: tuple, L8: int, device: str) -> cm.DeviceModulus:
    """The Barrett and Montgomery material of ``moduli`` (all of exactly
    L8 bytes) with a leading table axis, on ``device``; no Montgomery
    material when any modulus is even."""
    L16 = -(-L8 // 2)
    L32 = -(-L16 // 2)
    W = 2 * L32

    def t(rows):
        return bi.to_device(np.stack(rows), device)

    mont = [mg.mont_constants(m, L32, limb_bits=32) for m in moduli]
    mp = minv = r1 = r2 = None
    if all(mont):
        R = 1 << (32 * L32)
        # -m^{-1} mod 2^32 as the int32 of the same bits
        mp = bi.to_device(np.array([c[0] - (c[0] >> 31 << 32)
                                    for c in mont], np.int32), device)
        minv = t([bi.from_int((-pow(m, -1, R)) % R, W) for m in moduli])
        r1 = t([bi.from_int(c[1], W) for c in mont])
        r2 = t([bi.from_int(c[2], W) for c in mont])
    return cm.DeviceModulus(
        L16=L16, L32=L32,
        m16=t([bi.from_int(m, L16) for m in moduli]),
        mu16=t([bi.barrett_mu(m, L16) for m in moduli]),
        mw=t([bi.from_int(m, W) for m in moduli]),
        muw=t([bi.from_int((1 << (64 * L32)) // m, W + 2) for m in moduli]),
        mp=mp, minv=minv, r1=r1, r2=r2)


def rows_modulus(ms, L8: int, device=None) -> cm.RowsModulus:
    """Per-row modulus material: row i reduces mod ``ms[i]``.

    Every modulus must have EXACT byte length ``L8`` (same-width
    clustering is the caller's, the coalescer's, fusion invariant): one
    with a zero top byte raises ``ValueError``, a wider one
    ``OverflowError``, as in the reference.  The distinct moduli form the
    table (first appearance order); ``device`` defaults to the card.  The
    index goes to the device without a wait (``bigint.to_device``), its
    range noted from these host ints for the kernels' check
    (``common.index_range``).
    """
    dev = resolve_device(device)
    index: dict[int, int] = {}
    midx = []
    for m in ms:
        m = int(m)
        t = index.get(m)
        if t is None:
            _check_row_modulus(m, L8)
            t = index[m] = len(index)
        midx.append(t)
    moduli = tuple(index)
    if not moduli:
        raise ValueError("rows_modulus needs at least one row")
    idx = cm.note_index_range(
        bi.to_device(np.asarray(midx, np.int32), dev), 0, len(moduli) - 1)
    return cm.RowsModulus(_rows_table(moduli, L8, str(dev)), idx, moduli)


def _rows_operand(x, rm: cm.RowsModulus, name: str) -> torch.Tensor:
    """A (B, <=L16) limb tensor on the table's device, B = the rows."""
    L16 = rm.table.L16
    if not isinstance(x, torch.Tensor) or x.ndim != 2 \
            or x.shape[0] != rm.B or x.shape[1] > L16:
        raise ValueError(f"{name}: expected a ({rm.B}, <={L16}) limb tensor, "
                         f"got {getattr(x, 'shape', type(x))}")
    return _same_device(bi.fit(x, L16), rm.midx)


def mulmod_rows(a: torch.Tensor, b: torch.Tensor,
                rm: cm.RowsModulus) -> torch.Tensor:
    """(a*b) mod m row-wise, m = row i's modulus: (B, L16) x (B, L16) ->
    (B, L16), exact for any operands below 2^{16 L16}; Montgomery when
    every table modulus is odd, else Barrett."""
    a = _rows_operand(a, rm, "mulmod_rows a")
    b = _rows_operand(b, rm, "mulmod_rows b")
    if rm.B == 0:
        return torch.zeros_like(a)
    return mulmod_rows_limbs(a, b, rm)


def modexp_rows(base: torch.Tensor, exp: torch.Tensor, rm: cm.RowsModulus,
                method: str | None = None,
                reduce_impl: str | None = None) -> torch.Tensor:
    """base^exp mod m row-wise, per-row moduli AND exponents: base
    (B, L16), exp (B, Le16) radix-2^16 -> (B, L16); the ladder by
    ``method`` ("win4" default, or "binary"), the reduction by
    ``reduce_impl`` (default ``REPRO_REDUCE_IMPL``, read per call:
    Montgomery, or Barrett for a table with an even modulus)."""
    method = method or MODEXP_METHOD
    base = _rows_operand(base, rm, "modexp_rows base")
    if not isinstance(exp, torch.Tensor) or exp.ndim != 2 \
            or exp.shape[0] != rm.B:
        raise ValueError(f"modexp_rows exp: expected ({rm.B}, Le16), got "
                         f"{getattr(exp, 'shape', type(exp))}")
    _validate_method(method, exp.shape[1] * bi.LIMB_BITS)
    impl = _resolve_reduce(rm.montgomery, reduce_impl)
    if rm.B == 0:
        return torch.zeros_like(base)
    return modexp_rows_limbs(base, _same_device(exp, base), rm, method, impl)


@functools.lru_cache(maxsize=64)
def _tree_correction(moduli: tuple, L32: int, n: int,
                     device: str) -> torch.Tensor:
    """R^n mod m for each modulus, R = 2^{32 L32}: (T, 2 L32) int32 limbs
    on ``device``.  The Montgomery product tree over n factors ends at
    prod * R^{1-n}; one more product by this leaves prod
    (``kernels/prodtree.py``).  One small modexp a modulus, once per
    (table, n, device)."""
    R = 1 << (32 * L32)
    return bi.to_device(np.stack([bi.from_int(pow(R, n, m), 2 * L32)
                                  for m in moduli]), device)


def _prod(x: torch.Tensor, moduli: tuple, table: cm.DeviceModulus,
          midx: torch.Tensor | None, odd: bool) -> torch.Tensor:
    """The product over axis 1 of a checked (R, N >= 2, L16) tensor, one
    launch (the plain version on the CPU): Montgomery when every modulus
    is ``odd``, else Barrett."""
    impl = "montgomery" if odd else "barrett"
    if x.shape[0] == 0:
        return torch.zeros((0, table.L16), dtype=torch.int32,
                           device=x.device)
    corr = _tree_correction(moduli, table.L32, x.shape[1], str(x.device)) \
        if impl == "montgomery" else None
    return prod_rows_limbs(x, table, midx, impl, corr)


def _tree_operand(x, L16: int, name: str) -> torch.Tensor:
    if not isinstance(x, torch.Tensor) or x.ndim != 3 or x.shape[1] < 1 \
            or x.shape[2] > L16:
        raise ValueError(f"{name}: expected an (R, N >= 1, <={L16}) limb "
                         f"tensor, got {getattr(x, 'shape', type(x))}")
    return x


def prod_rows(x: torch.Tensor, rm: cm.RowsModulus) -> torch.Tensor:
    """Row-wise modular product over axis 1: (R, N, <=L16) -> (R, L16),
    row r mod its modulus; N = 1 gives ``x[:, 0]`` as it is.  One launch
    of the product-tree kernel, Montgomery per row, or Barrett for a
    table with an even modulus; exact ring products make the order
    immaterial."""
    x = _tree_operand(x, rm.table.L16, "prod_rows")
    R, n, _ = x.shape
    if R != rm.B:
        raise ValueError(f"prod_rows: ({R}, {n}, ...) for {rm.B} moduli")
    _same_device(x, rm.midx)
    if n == 1:
        return x[:, 0]
    return _prod(x, rm.moduli, rm.table, rm.midx, rm.montgomery)


def prod_mod(x: torch.Tensor, pack: ModulusPack) -> torch.Tensor:
    """:func:`prod_rows` under the one modulus of ``pack``: (R, N, <=L16)
    -> (R, L16), one launch on the pack's material as a one-row table."""
    x = _tree_operand(x, pack.L16, "prod_mod")
    if x.shape[1] == 1:
        return x[:, 0]
    table = _rows_table((pack.m_int,), pack.L8, str(x.device))
    return _prod(x, (pack.m_int,), table, None, pack.mp32 is not None)
