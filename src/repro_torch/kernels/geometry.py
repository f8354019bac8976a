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
per-row-modulus bodies (``mulmod_rows[...]``, ``modexp_rows[...]``: one
modulus per row, the serving path's cross-tenant launches) take the
geometry of their broadcast counterparts, but the Montgomery
``modexp_rows`` bodies, whose group size comes from a sweep at the
serving path's n^2.
The win4 and fixed ladders keep a 16-entry power table per integer in
dynamic shared memory.  The product tree's bodies (``prod_rows[...]``,
``csrc/prodtree.cu``) fold each row's factors with G groups of threads
and reduce the groups through shared memory: :func:`tree_geometry`
sizes them from the rows and the factors a row.

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
          "mulmod_rows[montgomery]", "mulmod_rows[barrett]",
          "modexp_rows[barrett,win4]",
          "modexp_rows[barrett,binary]", "modexp_rows[montgomery,win4]",
          "modexp_rows[montgomery,binary]",
          "prod_rows[montgomery]", "prod_rows[barrett]")
#: the product tree's bodies, sized by :func:`tree_geometry`; every other
#: body by :func:`launch_geometry`
TREE_BODIES = ("prod_rows[montgomery]", "prod_rows[barrett]")

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
       "mulmod_rows[montgomery]": 32, "mulmod_rows[barrett]": 32,
       "modexp_rows[barrett,win4]": 16,
       "modexp_rows[barrett,binary]": 8,
       "modexp_rows[montgomery,win4]": 16,
       "modexp_rows[montgomery,binary]": 16,
       # the product tree: TPI 16 was fastest of 8, 16 and 32 at every
       # shape of its sweep (TREE_GROUPS below)
       "prod_rows[montgomery]": 16, "prod_rows[barrett]": 16}
#: From this batch on, mulmod and both mulmod_rows bodies run
#: MULMOD_FULL_WORDS words per lane (8 or 16 threads per integer at the
#: main path's widths).  chip_smoke.py's
#: sweep on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6), device
#: ms at n^2 (k = 128) for TPI 32 / 16: B = 192 0.0318 / 0.0474, 2,304
#: 0.0647 / 0.0700, 4,608 0.1125 / 0.1066, 18,432 0.3976 / 0.3301; at p^2
#: (k = 64) for TPI 32 / 8: B = 192 0.0154 / 0.0269, 36,864 0.2639 /
#: 0.1846.  While the card is nearly empty one integer's latency rules
#: and the widest group wins; once it is full, 8 words per lane spend
#: fewer shuffles per word product.  The per-row bodies keep this rule
#: and 64-thread blocks: the same card's sweep over four moduli (TPI 8 /
#: 16 / 32 in 64-, 128- and 256-thread blocks, ``time_mulmod_rows_s1``)
#: found it the fastest, or within 4 % of the fastest, at each of S1's
#: and S2's shapes, B = 576 ... 4,608 at k = 64 and 128.  The Montgomery
#: body's two misses, device ms: k = 128, B = 2,304 TPI 16 0.0687 against
#: the rule's TPI 32 0.0708; k = 64, B = 4,608 TPI 32 0.0378 against the
#: rule's TPI 8 0.0394.
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
_TREE = ((32, 1), (32, 2), (32, 4), (16, 1), (16, 2), (16, 4), (16, 8),
         (8, 16))
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
    "mulmod_rows[montgomery]": _MULMOD,
    "mulmod_rows[barrett]": _MULMOD,
    "modexp_rows[barrett,win4]": ((16, 1), (16, 2), (16, 4), (16, 8)),
    "modexp_rows[barrett,binary]": ((8, 1), (8, 2), (8, 4), (8, 8), (8, 16)),
    "modexp_rows[montgomery,win4]": _MODEXP_ROWS_MONT,
    "modexp_rows[montgomery,binary]": _MODEXP_ROWS_MONT,
    "prod_rows[montgomery]": _TREE,
    "prod_rows[barrett]": _TREE,
}
#: threads per block of each kernel
BLOCK_THREADS = {"modexp": 64, "modexp_fixed": 32, "mulmod": 64,
                 "modexp_rows": 64, "mulmod_rows": 64}
#: the block sizes a sweep times (``launch_geometry(threads=...)``)
SWEEP_THREADS = (64, 128)
TABLE_ENTRIES = 16
#: the product tree: G, the groups that fold one row's factors, is
#: TREE_GROUPS (never more than the row's factors); a block holds one row,
#: or several when a row has fewer than TREE_MIN_THREADS threads (two
#: warps).  chip_smoke.py's sweep on an NVIDIA H100 80GB HBM3 at 700 W,
#: n^2 (k = 128), 192 factors a row, CUDA-event ms of the Montgomery body
#: at TPI 16 and G = 4 / 8 / 16 / 32 (one row a block): S1's 2,304 rows
#: over 4 moduli 3.924 / 3.907 / 4.070 / 6.029, the runtime's 576 rows
#: 1.446 / 1.211 / 1.211 / 1.674, the main path's 192 rows 0.953 / 0.628
#: / 0.568 / 0.678; TPI 8 and 32 were slower at every shape, the Barrett
#: body ranked the same.  G = 16 is the best or within 5 % of it at each.
#: The other instantiations of _TREE are built for that sweep and for
#: the card tests at every swept geometry.
TREE_GROUPS = 16
TREE_MIN_THREADS = 64
#: the product tree's largest block by threads per integer: an SM's 64K
#: registers must hold a block.  ``-Xptxas -v`` on sm_90a (chip_smoke.py,
#: NVIDIA H100 80GB HBM3): Montgomery / Barrett at k = 128 take 124 / 164
#: registers at TPI 8, 72 / 98 at TPI 16, 64 / 78 at TPI 32, so 1,024
#: threads fit none and 512 fit all but TPI 8's Barrett body
TREE_MAX_THREADS = {8: 256, 16: 512, 32: 512}


@dataclasses.dataclass(frozen=True)
class Geometry:
    tpi: int          # threads per big integer
    words: int        # 32-bit words each thread holds
    per_block: int    # big integers per block
    blocks: int
    smem: int         # dynamic shared memory per block, bytes
    groups: int = 1   # product tree: groups per row (per_block / groups
                      # rows a block)

    @property
    def threads(self) -> int:
        return self.tpi * self.per_block


def body_name(kernel: str, reduce_impl: str = "montgomery",
              method: str = "win4") -> str:
    """The body a launch of ``kernel`` runs: ``mulmod``,
    ``mulmod_rows[<reduce_impl>]``, ``modexp[<reduce_impl>,<method>]``,
    ``modexp_rows[<reduce_impl>,<method>]`` or
    ``modexp_fixed[<reduce_impl>]`` or ``prod_rows[<reduce_impl>]``."""
    if kernel in ("prod_rows", "mulmod_rows"):
        return f"{kernel}[{reduce_impl}]"
    if kernel == "mulmod":
        return kernel
    if kernel in ("modexp", "modexp_rows"):
        return f"{kernel}[{reduce_impl},{method}]"
    return f"modexp_fixed[{reduce_impl}]"


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _words(body: str, k: int, tpi: int) -> int:
    """Words a lane holds at width k, for an instantiated shape of
    ``body`` (raises otherwise)."""
    if not 1 <= k <= MAX_WORDS:
        raise ValueError(f"modulus of {k} 32-bit words is outside the "
                         f"kernels' 1..{MAX_WORDS} ({32 * MAX_WORDS} bits)")
    words = _pow2_at_least(-(-k // tpi))
    if (tpi, words) not in SHAPES[body]:
        raise ValueError(
            f"{body} has no instantiation for {tpi} threads per integer "
            f"at {k} words ({words} per thread); instantiated: "
            f"{SHAPES[body]}")
    return words


def group_size(body: str, B: int, k: int) -> int:
    """Threads per integer of ``body`` at batch B and width k:
    :data:`TPI`'s, but for a ``mulmod`` or ``mulmod_rows[...]`` batch that
    fills the card the size that gives each lane :data:`MULMOD_FULL_WORDS`
    words (at least 8 threads, at most :data:`TPI`'s)."""
    if body.split("[")[0] in ("mulmod", "mulmod_rows") \
            and B >= MULMOD_FULL_BATCH:
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
    if body not in BODIES or body in TREE_BODIES:
        raise ValueError(f"unknown kernel body {body!r}; expected one of "
                         f"{BODIES[:-len(TREE_BODIES)]} (the product "
                         f"tree's: tree_geometry)")
    if not 1 <= k <= MAX_WORDS:
        raise ValueError(f"modulus of {k} 32-bit words is outside the "
                         f"kernels' 1..{MAX_WORDS} ({32 * MAX_WORDS} bits)")
    if B < 0:
        raise ValueError(f"negative batch {B}")
    kernel = body.split("[")[0]
    tpi = group_size(body, B, k) if tpi is None else tpi
    words = _words(body, k, tpi)
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


def tree_groups(N: int, tpi: int) -> int:
    """The default G of a product tree over rows of N factors:
    TREE_GROUPS, but at most N (the largest power of two not above it)
    and at most a block's threads (TREE_MAX_THREADS)."""
    return max(1, min(TREE_GROUPS, 1 << (max(N, 1).bit_length() - 1),
                      TREE_MAX_THREADS[tpi] // tpi))


def tree_geometry(body: str, R: int, N: int, k: int, tpi: int | None = None,
                  groups: int | None = None,
                  threads: int | None = None) -> Geometry:
    """Geometry of one product-tree launch of ``body`` (one of
    :data:`TREE_BODIES`) over R rows of N factors of k words: ``groups``
    (G, a power of two) groups of ``tpi`` threads fold a row's factors,
    ``threads`` a block (a multiple of tpi G: whole rows a block; default
    tpi G, at least TREE_MIN_THREADS).  ``per_block`` counts the block's
    groups, ``blocks`` covers the rows; the tree's shared memory is one
    row of words a group when G > 1.  ``tpi``, ``groups`` and ``threads``
    other than the defaults time the sweep's candidates.  Raises
    ``ValueError`` for another body, a width outside 1..MAX_WORDS, a
    negative R, N < 1, a shape that is not instantiated or a block that
    Hopper refuses."""
    if body not in TREE_BODIES:
        raise ValueError(f"unknown product-tree body {body!r}; expected one "
                         f"of {TREE_BODIES}")
    if R < 0 or N < 1:
        raise ValueError(f"{body}: {R} rows of {N} factors")
    tpi = TPI[body] if tpi is None else tpi
    words = _words(body, k, tpi)      # tpi is instantiated: 8, 16 or 32
    G = tree_groups(N, tpi) if groups is None else groups
    if G < 1 or G & (G - 1):
        raise ValueError(f"{body}: {G} groups a row is not a power of two")
    row_threads = tpi * G
    if threads is None:
        threads = max(row_threads, TREE_MIN_THREADS)
    cap = TREE_MAX_THREADS[tpi]
    if threads > cap or threads % 32 or threads % row_threads:
        raise ValueError(f"{body}: {threads} threads per block do not hold "
                         f"whole warps and whole rows of {G} groups of "
                         f"{tpi} threads within {cap}")
    rows = threads // row_threads
    smem = threads * words * 4 if G > 1 else 0
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"{body} at {k} words: {smem} bytes of shared "
                         f"memory per block exceed {MAX_SMEM_BYTES}")
    return Geometry(tpi=tpi, words=words, per_block=threads // tpi,
                    blocks=-(-R // rows), smem=smem, groups=G)
