"""Limb-op roofline for the encrypted ADMM stack (RunReport ``runtime``).

Port of the limb-op half of ``repro.analysis.roofline``
(:func:`ladder_mulmods`, :func:`limb_ops`, :func:`achieved_vs_peak`): the
16-bit limb multiplications an OpCounter ``ops`` dict implies, and the
rate they were retired at over a run's (virtual or wall) seconds against
the card's peak.  The XLA-HLO half of the reference module (three-term
roofline of a compiled LM step) belongs to the language-model stack and
is not here.
"""
from __future__ import annotations

import os

LIMB_BITS = 16                 # the public limb width (core/bigint.py)
#: Peak 16-bit limb products per second of one H100 SXM at 700 W.  The
#: 32-bit integer multiply-add pipe has 64 lanes per SM on compute
#: capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
#: throughput), a quarter of the 128 fp32 lanes behind 67 TFLOP/s (NVIDIA
#: H100 data sheet): 67e12 / 4 = 16.75e12 IMAD results per second, the
#: figure the kernels' bounds use.  A 32x32 -> 64-bit word product takes
#: two IMAD results (low and high word) and covers four 16x16-bit limb
#: products, so the peak is 16.75e12 / 2 * 4 = 3.35e13 limb products/s.
IMAD_PER_S = 67e12 / 4
PEAK_LIMB_MULS_PER_S = IMAD_PER_S / 2 * 4
GAMMA2_EXP_BITS = 20           # typical Gamma_2 exponent width (~log2 Delta)


def _active_method() -> str:
    return os.environ.get("REPRO_MODEXP_METHOD", "win4")


def _active_reduce_impl() -> str:
    return os.environ.get("REPRO_REDUCE_IMPL", "montgomery")


def ladder_mulmods(method: str, exp_bits: int,
                   reduce_impl: str = "barrett") -> float:
    """Executed mulmods for one ModExp under the active ladder schedule.

    * ``binary`` — the constant-time ladder executes BOTH the squaring and
      the selected multiply every bit: ``2/bit``;
    * ``win4`` — 4 squarings + 1 oblivious table select per 4-bit window
      plus the 15-mulmod power table: ``1.25/bit + 15``;
    * ``fixed`` — the batch-shared host-known-exponent ladder
      (``ops.modexp_fixed``): the win4 schedule over the exponent's TRUE
      bit-length.

    ``reduce_impl="montgomery"`` adds the 2 domain enter/leave
    REDC-equivalents.
    """
    if method == "binary":
        n = 2.0 * exp_bits
    elif method in ("win4", "fixed"):
        n = 1.25 * exp_bits + 15.0 if exp_bits > 0 else 0.0
    else:
        raise ValueError(f"unknown modexp method {method!r}")
    if reduce_impl == "montgomery" and n > 0:
        n += 2.0
    return n


def limb_ops(ops: dict, key_bits: int,
             exp_bits: int = GAMMA2_EXP_BITS,
             method: str | None = None,
             reduce_impl: str | None = None) -> dict:
    """16-bit limb-multiplications implied by an OpCounter ``ops`` dict.

    ``ops`` is the RunReport ``"ops"`` section: ``{phase: {op: count}}``.
    Ciphertexts live mod n^2, i.e. ``L = ceil(2*key_bits / 16)`` limbs.
    Schoolbook costs per op, priced by the active ladder schedule
    (``method`` defaults to ``$REPRO_MODEXP_METHOD``/win4 and
    ``reduce_impl`` to ``$REPRO_REDUCE_IMPL``/montgomery, as
    ``kernels/ops.py`` resolves them):

    * ``mulmod``  — one LxL product: ``L^2``;
    * ``modexp``  — :func:`ladder_mulmods`(method, exp_bits) ``* L^2``;
    * ``enc``/``dec`` — one full-width exponentiation with a key-constant
      exponent: :func:`ladder_mulmods`("fixed", key_bits) ``* L^2``.
    """
    method = method or _active_method()
    reduce_impl = reduce_impl or _active_reduce_impl()
    L = max(1, -(-2 * key_bits // LIMB_BITS))
    totals: dict[str, int] = {}
    for per_phase in ops.values():
        for op, n in per_phase.items():
            totals[op] = totals.get(op, 0) + int(n)
    key_exp = ladder_mulmods("fixed", key_bits, reduce_impl)
    per_op = {
        "modexp": ladder_mulmods(method, exp_bits, reduce_impl) * L * L,
        "mulmod": float(L * L),
        "enc": key_exp * L * L,
        "dec": key_exp * L * L,
    }
    by_op = {op: totals.get(op, 0) * per_op[op]
             for op in per_op if totals.get(op)}
    return {"key_bits": key_bits, "limbs": L, "exp_bits": exp_bits,
            "method": method, "reduce_impl": reduce_impl,
            "by_op": by_op, "limb_muls": sum(by_op.values())}


def achieved_vs_peak(ops: dict, key_bits: int, seconds: float,
                     peak: float = PEAK_LIMB_MULS_PER_S,
                     exp_bits: int = GAMMA2_EXP_BITS,
                     method: str | None = None,
                     reduce_impl: str | None = None) -> dict:
    """Achieved limb-mul rate over ``seconds`` vs the card's peak.

    ``seconds`` may be wall or virtual time: a RunReport built on the
    simulated clock reports utilization of the modeled device.
    """
    lo = limb_ops(ops, key_bits, exp_bits=exp_bits, method=method,
                  reduce_impl=reduce_impl)
    rate = lo["limb_muls"] / seconds if seconds > 0 else 0.0
    lo.update(seconds=seconds, peak_limb_muls_per_s=peak,
              limb_muls_per_s=rate,
              fraction_of_peak=rate / peak if peak > 0 else 0.0)
    return lo
