"""Montgomery (REDC) plain versions and the host constants.

Port of ``repro.kernels.montgomery``.  The reference's radix-256 REDC
sweep (``redc2d``) becomes, in the plain version, the vectorized two-
product form over the whole modulus width W = 2 L32 limbs:

    u = (t mod R) * (-m^{-1} mod R) mod R,     REDC(t) = (t + u m) / R,

with R = 2^{32 L32} — the same R as the CUDA kernels' word-serial CIOS
loop, so both use one set of constants.  For t < R m the quotient is
< 2m and one conditional subtraction makes it canonical; every call
below has one operand < m, which keeps t < R m.

Host constants: :func:`mont_constants` at ``limb_bits=8`` reproduces the
reference's radix-256 material exactly (``ModulusPack.mp8/r1_8/r2_8``);
the kernels take it at ``limb_bits=32``.  :func:`exp_windows` is the
reference's MSB-first 4-bit schedule of a host-known exponent.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..core import bigint as bi
from . import common as cm


def mont_constants(m: int, n_limbs: int,
                   limb_bits: int = 8) -> tuple[int, int, int] | None:
    """``(mp, r1, r2)`` for modulus m at ``n_limbs`` limbs of ``limb_bits``.

    ``mp = -m^{-1} mod 2^limb_bits``, ``r1 = R mod m`` (Montgomery 1),
    ``r2 = R^2 mod m`` (domain-enter multiplier), R = 2^{limb_bits n_limbs};
    ``None`` for even moduli (REDC needs gcd(m, 2) = 1; callers fall back
    to Barrett).
    """
    if m % 2 == 0 or m <= 1:
        return None
    R = 1 << (limb_bits * n_limbs)
    mp = (-pow(m, -1, 1 << limb_bits)) % (1 << limb_bits)
    return mp, R % m, (R * R) % m


def exp_windows(e: int) -> tuple[int, ...]:
    """Host-known exponent -> MSB-first 4-bit window tuple (``e = 0``
    gives the empty tuple; the ladders then return 1)."""
    if e < 0:
        raise ValueError("exp_windows requires a non-negative exponent")
    n_win = -(-max(e.bit_length(), 0) // 4)
    return tuple((e >> (4 * j)) & 0xF for j in reversed(range(n_win)))


def redc(t: torch.Tensor, dm: cm.DeviceModulus) -> torch.Tensor:
    """t (B, <=2W) normalized * R^{-1} mod m -> (B, W) int64 canonical;
    needs t < R m.

    The low W limbs of t + u m are 0 by construction, so they are not
    normalized (their carries would ripple through every one of them):
    their carry into limb W is the exact quotient of their value by R,
    read off the top two coefficients.  Every coefficient is below
    C = W 2^32 + 2^16, so the coefficients below those two add less than
    C / 2^48 < 1 to it (for W < 2^15), and the carry is the ceiling of
    (s_{W-1} 2^16 + s_{W-2}) / 2^32.
    """
    W = dm.W
    t = bi.fit(bi._i64(t), 2 * W + 1)
    u = bi._norm(bi._conv(t[..., :W], dm.minv)[..., :W])  # (t mod R) m' mod R
    s = t + bi.fit(bi._conv(u, dm.mw), 2 * W + 1)          # t + u m < 2Rm
    top = (s[..., W - 1] << bi.LIMB_BITS) + s[..., W - 2]
    high = s[..., W:].clone()
    high[..., 0] += (top + (1 << 2 * bi.LIMB_BITS) - 1) >> 2 * bi.LIMB_BITS
    return bi._csub(bi._norm(high), dm.mw)[..., :W]        # (t + u m) / R


def montmul(a: torch.Tensor, b: torch.Tensor,
            dm: cm.DeviceModulus) -> torch.Tensor:
    """Montgomery product a*b*R^{-1} mod m; (B, W) x (B, W) -> (B, W)."""
    return redc(bi._mul(a, b), dm)


def mont_ladder(ladder, base: torch.Tensor, arg,
                dm: cm.DeviceModulus) -> torch.Tensor:
    """Run ``ladder`` in the Montgomery domain: enter with r2, start from
    r1 (Montgomery 1), leave by one REDC; (B, L16) -> (B, L16)."""
    base_w = bi.fit(bi._i64(base), dm.W)
    base_m = montmul(base_w, dm.r2, dm)
    res = ladder(lambda a, b: montmul(a, b, dm),
                 bi._i64(dm.r1).expand_as(base_w), base_m, arg)
    return bi.fit(redc(res, dm), dm.L16).to(torch.int32)


def modexp_mont(base: torch.Tensor, exp: torch.Tensor,
                dm: cm.DeviceModulus, method: str) -> torch.Tensor:
    """Per-element exponents, binary or win4 ladder, over REDC."""
    ladder = cm.ladder_win4 if method == "win4" else cm.ladder_binary
    return mont_ladder(ladder, base, exp, dm)


def modexp_mont_fixed(base: torch.Tensor, windows: Sequence[int],
                      dm: cm.DeviceModulus) -> torch.Tensor:
    """One host-known exponent (its 4-bit windows) over REDC."""
    return mont_ladder(cm.ladder_fixed, base, windows, dm)
