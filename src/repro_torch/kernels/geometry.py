"""Launch geometry of the limb kernels, in one place.

:func:`launch_geometry` gives, for one launch of a kernel body at batch B
and modulus width k (32-bit words), the threads per big integer, the
words each thread holds, the integers per block, the blocks and the
dynamic shared memory.  The C launchers (``csrc/*.cu``) receive these
values, check them and launch with them; they compute none of their own.

Every kernel runs a group of ``TPI`` threads per integer, each holding
ceil(k / TPI) words rounded up to a power of two, one of the
instantiations that ``SHAPES`` lists (the ``*_SHAPES`` macros of the
sources).  ``modexp_fixed`` runs one warp per block, so its small batches
spread over the SMs; ``modexp`` and ``mulmod`` run 64-thread blocks.  The
per-row-modulus bodies (``mulmod_rows``, ``modexp_rows[...]``: one modulus
per row, the serving path's cross-tenant launches) take the geometry of
their broadcast counterparts, but the Montgomery ``modexp_rows`` bodies,
whose group size comes from a sweep at the serving path's n^2.
The win4 and fixed ladders keep a 16-entry power table per integer in
dynamic shared memory.

Nothing here touches a device: the CPU tests check every width.
"""
from __future__ import annotations

import dataclasses

#: widest modulus the kernels take, in 32-bit words (``MAXW`` in limbs.cuh)
MAX_WORDS = 128
#: shared memory one block may use on Hopper (227 KB), and threads per block
MAX_SMEM_BYTES = 227 * 1024
MAX_THREADS = 1024

#: every kernel body: the launch counters' keys and chip_smoke's names
BODIES = ("mulmod",
          "modexp[montgomery,win4]", "modexp[montgomery,binary]",
          "modexp[barrett,win4]", "modexp[barrett,binary]",
          "modexp_fixed[montgomery]", "modexp_fixed[barrett]",
          "mulmod_rows", "modexp_rows[barrett,win4]",
          "modexp_rows[barrett,binary]", "modexp_rows[montgomery,win4]",
          "modexp_rows[montgomery,binary]")

#: threads per integer of each body, at every width (mulmod: below
#: MULMOD_FULL_BATCH).  modexp's bodies run 8 but modexp[barrett,win4]
#: 16: chip_smoke.py's sweep on an NVIDIA H100 80GB HBM3 at 700 W
#: (PERF.md section 6), device ms at p^2 (k = 64), B = 36,864, 64-bit
#: exponents, TPI 4 / 8 / 16: [barrett,win4] 31.68 / 20.12 / 18.99,
#: [barrett,binary] 30.83 / 24.28 / 25.68, [montgomery,win4] 12.96 /
#: 8.62 / 9.83, [montgomery,binary] 12.52 / 10.43 / 12.93.  The win4
#: table's shared memory limits TPI 8's Barrett blocks per SM.
#: The per-row Montgomery bodies run 16: the same card's sweep at S1's
#: n^2 (k = 128, four moduli), CUDA-event ms for TPI 8 / 16 / 32 in
#: 64-thread blocks (128-thread blocks: within 1 % at TPI 16 and 32; at
#: TPI 8 5 % faster on the matvec, 18-46 % slower at 2,048 bits):
#: [montgomery,win4] matvec B = 442,368, 64-bit exponents 637.58 /
#: 389.67 / 451.96, enc B = 4,608, 2,048-bit 192.77 / 132.45 / 140.21,
#: dec B = 2,304, 2,048-bit 104.66 / 80.85 / 82.82; [montgomery,binary]
#: matvec 592.05 / 484.14 / 614.15.  Resident integers per SM at TPI
#: 8 / 16 / 32 (win4, by shared memory / by registers: 123, 71 and 47
#: registers): 24 / 64, 24 / 56, 26 / 42: the 8 KB table of an integer
#: at n^2 still caps residency at TPI 16; TPI 32 spends twice the
#: shuffles per word product, TPI 8 runs 6 warps an SM.
TPI = {"mulmod": 32,
       "modexp[montgomery,win4]": 8, "modexp[montgomery,binary]": 8,
       "modexp[barrett,win4]": 16, "modexp[barrett,binary]": 8,
       "modexp_fixed[montgomery]": 32, "modexp_fixed[barrett]": 32,
       "mulmod_rows": 32, "modexp_rows[barrett,win4]": 16,
       "modexp_rows[barrett,binary]": 8,
       "modexp_rows[montgomery,win4]": 16,
       "modexp_rows[montgomery,binary]": 16}
#: From this batch on, mulmod runs MULMOD_FULL_WORDS words per lane (8 or
#: 16 threads per integer at the main path's widths).  chip_smoke.py's
#: sweep on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6), device
#: ms at n^2 (k = 128) for TPI 32 / 16: B = 192 0.0318 / 0.0474, 2,304
#: 0.0647 / 0.0700, 4,608 0.1125 / 0.1066, 18,432 0.3976 / 0.3301; at p^2
#: (k = 64) for TPI 32 / 8: B = 192 0.0154 / 0.0269, 36,864 0.2639 /
#: 0.1846.  While the card is nearly empty one integer's latency rules
#: and the widest group wins; once it is full, 8 words per lane spend
#: fewer shuffles per word product.
MULMOD_FULL_BATCH = 4096
MULMOD_FULL_WORDS = 8
#: (threads per integer, words per thread) of every instantiation of each
#: body: TPI's group size at every width up to 128 words, and the other
#: group sizes timed against it at k = 64 (mulmod and mulmod_rows: every
#: group size at every width; the per-row Barrett modexp bodies: their
#: group size only; the per-row Montgomery bodies: the others at k = 128)
_MODEXP = ((8, 1), (8, 2), (8, 4), (8, 8), (8, 16), (4, 16), (16, 4))
_MODEXP_FIXED = ((32, 1), (32, 2), (32, 4), (16, 4), (8, 8))
_MODEXP_ROWS_MONT = ((16, 1), (16, 2), (16, 4), (16, 8), (8, 16), (32, 4))
_MULMOD = ((32, 1), (32, 2), (32, 4), (16, 1), (16, 2), (16, 4), (16, 8),
           (8, 1), (8, 2), (8, 4), (8, 8), (8, 16))
SHAPES = {
    "mulmod": _MULMOD,
    "modexp[montgomery,win4]": _MODEXP,
    "modexp[montgomery,binary]": _MODEXP,
    "modexp[barrett,win4]": ((16, 1), (16, 2), (16, 4), (16, 8), (8, 8),
                             (4, 16)),
    "modexp[barrett,binary]": _MODEXP,
    "modexp_fixed[montgomery]": _MODEXP_FIXED,
    "modexp_fixed[barrett]": _MODEXP_FIXED,
    "mulmod_rows": _MULMOD,
    "modexp_rows[barrett,win4]": ((16, 1), (16, 2), (16, 4), (16, 8)),
    "modexp_rows[barrett,binary]": ((8, 1), (8, 2), (8, 4), (8, 8), (8, 16)),
    "modexp_rows[montgomery,win4]": _MODEXP_ROWS_MONT,
    "modexp_rows[montgomery,binary]": _MODEXP_ROWS_MONT,
}
#: threads per block of each kernel
BLOCK_THREADS = {"modexp": 64, "modexp_fixed": 32, "mulmod": 64,
                 "modexp_rows": 64, "mulmod_rows": 64}
#: the block sizes a sweep times (``launch_geometry(threads=...)``)
SWEEP_THREADS = (64, 128)
TABLE_ENTRIES = 16


@dataclasses.dataclass(frozen=True)
class Geometry:
    tpi: int          # threads per big integer
    words: int        # 32-bit words each thread holds
    per_block: int    # big integers per block
    blocks: int
    smem: int         # dynamic shared memory per block, bytes

    @property
    def threads(self) -> int:
        return self.tpi * self.per_block


def body_name(kernel: str, reduce_impl: str = "montgomery",
              method: str = "win4") -> str:
    """The body a launch of ``kernel`` runs: ``mulmod``, ``mulmod_rows``,
    ``modexp[<reduce_impl>,<method>]``,
    ``modexp_rows[<reduce_impl>,<method>]`` or
    ``modexp_fixed[<reduce_impl>]``."""
    if kernel in ("mulmod", "mulmod_rows"):
        return kernel
    if kernel in ("modexp", "modexp_rows"):
        return f"{kernel}[{reduce_impl},{method}]"
    return f"modexp_fixed[{reduce_impl}]"


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def group_size(body: str, B: int, k: int) -> int:
    """Threads per integer of ``body`` at batch B and width k:
    :data:`TPI`'s, but for a ``mulmod`` or ``mulmod_rows`` batch that fills
    the card the size that gives each lane :data:`MULMOD_FULL_WORDS` words
    (at least 8 threads, at most :data:`TPI`'s)."""
    if body in ("mulmod", "mulmod_rows") and B >= MULMOD_FULL_BATCH:
        return min(TPI[body],
                   max(8, _pow2_at_least(-(-k // MULMOD_FULL_WORDS))))
    return TPI[body]


def launch_geometry(body: str, B: int, k: int, tpi: int | None = None,
                    threads: int | None = None) -> Geometry:
    """Geometry of one launch of ``body`` (one of :data:`BODIES`) over B
    integers of k words.  ``tpi`` picks another instantiated group size
    than :func:`group_size`'s, ``threads`` another block size than
    :data:`BLOCK_THREADS`', to time the candidates.  Raises
    ``ValueError`` for a width outside 1..MAX_WORDS, a negative batch, an
    instantiation that does not exist, or a block that would exceed 1,024
    threads or 227 KB of shared memory."""
    if body not in BODIES:
        raise ValueError(f"unknown kernel body {body!r}; expected one of "
                         f"{BODIES}")
    if not 1 <= k <= MAX_WORDS:
        raise ValueError(f"modulus of {k} 32-bit words is outside the "
                         f"kernels' 1..{MAX_WORDS} ({32 * MAX_WORDS} bits)")
    if B < 0:
        raise ValueError(f"negative batch {B}")
    kernel = body.split("[")[0]
    tpi = group_size(body, B, k) if tpi is None else tpi
    words = _pow2_at_least(-(-k // tpi))
    if (tpi, words) not in SHAPES[body]:
        raise ValueError(
            f"{body} has no instantiation for {tpi} threads per integer "
            f"at {k} words ({words} per thread); instantiated: "
            f"{SHAPES[body]}")
    if threads is None:
        threads = BLOCK_THREADS[kernel]
    table = kernel == "modexp_fixed" or body.endswith(",win4]")
    smem = TABLE_ENTRIES * words * threads * 4 if table else 0
    if threads % 32:
        raise ValueError(f"{body}: {threads} threads per block is not a "
                         f"whole number of warps")
    if threads > MAX_THREADS:
        raise ValueError(f"{body} at {k} words: {threads} threads per block "
                         f"exceed {MAX_THREADS}")
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"{body} at {k} words: {smem} bytes of shared "
                         f"memory per block exceed {MAX_SMEM_BYTES}")
    per_block = threads // tpi
    return Geometry(tpi=tpi, words=words, per_block=per_block,
                    blocks=-(-B // per_block), smem=smem)
