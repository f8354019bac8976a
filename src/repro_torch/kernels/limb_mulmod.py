"""mulmod: (a * b) mod m over a batch — the CUDA kernel and its plain version.

Port of ``repro.kernels.limb_mulmod.mulmod_pallas`` (Barrett).  The kernel
is ``csrc/mulmod.cu``; :func:`mulmod_plain` computes the same canonical
residues in plain PyTorch (radix-2^16 Barrett, ``core.bigint``).
:func:`mulmod_limbs` picks by where the operands live: a CUDA tensor
launches the kernel (or raises), a CPU tensor takes the plain version.

Both are exact for any operands below 2^{16 L16}, not only reduced ones:
``paillier_vec._reduce_into`` multiplies full-width chunks by 1.

``mulmod_rows`` (the reference's jitted ``ops.mulmod_rows``, not a
Pallas kernel) takes one modulus per row, from a table
(:class:`common.RowsModulus`), and follows the moduli: Montgomery when
every table modulus is odd (two REDC products, a R mod m and then a b mod
m, on the table's R^2 mod m and -m^{-1}), Barrett for a table with an
even modulus.  :func:`mulmod_rows_cuda` launches the two bodies of
``mulmod_rows_kernel`` in the same source, :func:`mulmod_rows_plain` runs
the same reductions over the gathered per-row moduli.
"""
from __future__ import annotations

import torch

from ..core import bigint as bi
from . import build, geometry
from . import common as cm
from . import montgomery as mg


def mulmod_plain(a: torch.Tensor, b: torch.Tensor,
                 dm: cm.DeviceModulus) -> torch.Tensor:
    """(B, L16) x (B, L16) -> (B, L16) int32: (a*b) mod m, plain PyTorch."""
    return cm.barrett_mulmod(a, b, dm).to(torch.int32)


def _row_stride(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    """``x`` with unit column stride and its row stride: a column slice
    keeps its stride, a broadcast row (stride 0) stays one row."""
    x = x.to(torch.int32)
    if x.shape[1] > 1 and x.stride(1) != 1:
        x = x.contiguous()
    return x, x.stride(0) if x.shape[0] > 1 else 0


def mulmod_cuda(a: torch.Tensor, b: torch.Tensor, dm: cm.DeviceModulus,
                tpi: int | None = None) -> torch.Tensor:
    """The ``csrc/mulmod.cu`` kernel on CUDA tensors (same contract).
    ``b`` may be one row broadcast to every row of ``a`` (stride 0, as
    ``expand`` gives): the kernel reads that row for every element.
    ``tpi`` times another instantiated group size than the launch
    geometry's own (``geometry.launch_geometry``)."""
    B = a.shape[0]
    build.require_rows("mulmod a", a, B, dm.L16)
    build.require_rows("mulmod b", b, B, dm.L16)
    (a, sa), (b, sb) = _row_stride(a), _row_stride(b)
    out = torch.empty((B, dm.L16), dtype=torch.int32, device=a.device)
    if B == 0:
        return out
    g = geometry.launch_geometry("mulmod", B, dm.L32, tpi)
    launch = build.launcher("mulmod")
    with torch.cuda.device(a.device):
        rc = launch(a.data_ptr(), sa, b.data_ptr(), sb, out.data_ptr(), B,
                    dm.L16, dm.mw.data_ptr(), dm.muw.data_ptr(), dm.L32,
                    g.tpi, g.words, g.threads, g.blocks,
                    torch.cuda.current_stream(a.device).cuda_stream)
    build.check(rc, "mulmod")
    build.count_launch("mulmod", B, dm.L32)
    return out


def rows_reduction(rm: cm.RowsModulus, reduce_impl: str | None) -> str:
    """The reduction of a ``mulmod_rows`` launch: ``reduce_impl``, by
    default the moduli's (Montgomery when every table modulus is odd,
    else Barrett).  Raises for Montgomery on a table with an even
    modulus."""
    impl = reduce_impl or ("montgomery" if rm.montgomery else "barrett")
    if impl not in ("montgomery", "barrett"):
        raise ValueError(f"mulmod_rows: unknown reduction {impl!r}")
    if impl == "montgomery" and not rm.montgomery:
        raise ValueError("mulmod_rows: Montgomery needs every table "
                         "modulus odd")
    return impl


def mulmod_mont_plain(a: torch.Tensor, b: torch.Tensor,
                      dm: cm.DeviceModulus) -> torch.Tensor:
    """(B, L16) x (B, L16) -> (B, L16) int32: (a*b) mod m (m odd) by the
    Montgomery body's two products, REDC(a R^2) = a R mod m, then
    REDC(a R b) = a b mod m; exact for any operands below 2^{16 L16}."""
    t = mg.montmul(bi.fit(bi._i64(a), dm.W), dm.r2, dm)    # a R mod m
    out = mg.montmul(t, bi.fit(bi._i64(b), dm.W), dm)      # a b mod m
    return bi.fit(out, dm.L16).to(torch.int32)


def mulmod_rows_plain(a: torch.Tensor, b: torch.Tensor, rm: cm.RowsModulus,
                      reduce_impl: str | None = None) -> torch.Tensor:
    """(B, L16) x (B, L16) -> (B, L16) int32: (a*b) mod row i's modulus,
    plain PyTorch, by the kernel's reduction (:func:`rows_reduction`):
    :func:`mulmod_mont_plain` or Barrett over the gathered moduli."""
    dm = rm.per_row()
    if rows_reduction(rm, reduce_impl) == "barrett":
        return mulmod_plain(a, b, dm)
    return mulmod_mont_plain(a, b, dm)


def mulmod_rows_cuda(a: torch.Tensor, b: torch.Tensor, rm: cm.RowsModulus,
                     reduce_impl: str | None = None, tpi: int | None = None,
                     threads: int | None = None) -> torch.Tensor:
    """The ``mulmod_rows_kernel`` of ``csrc/mulmod.cu`` on CUDA tensors
    (same contract as :func:`mulmod_rows_plain`; ``b`` may be a broadcast
    row as for :func:`mulmod_cuda`).  ``tpi`` and ``threads`` time another
    group and block size than the launch geometry's own.  Nothing here
    waits for the device (``build.require_index`` checks the row index
    against its range on the host)."""
    B, dm = a.shape[0], rm.table
    impl = rows_reduction(rm, reduce_impl)
    build.require_rows("mulmod_rows a", a, B, dm.L16)
    build.require_rows("mulmod_rows b", b, B, dm.L16)
    midx = build.require_index("mulmod_rows", rm, B, a.device)
    (a, sa), (b, sb) = _row_stride(a), _row_stride(b)
    out = torch.empty((B, dm.L16), dtype=torch.int32, device=a.device)
    if B == 0:
        return out
    mont = impl == "montgomery"
    body = geometry.body_name("mulmod_rows", impl)
    g = geometry.launch_geometry(body, B, dm.L32, tpi, threads)
    aux, mp = (dm.r2, dm.mp.data_ptr()) if mont else (dm.muw, None)
    launch = build.launcher("mulmod_rows")
    with torch.cuda.device(a.device):
        rc = launch(a.data_ptr(), sa, b.data_ptr(), sb, out.data_ptr(), B,
                    dm.L16, dm.mw.data_ptr(), aux.data_ptr(), mp,
                    midx.data_ptr(), dm.L32, int(mont), g.tpi, g.words,
                    g.threads, g.blocks,
                    torch.cuda.current_stream(a.device).cuda_stream)
    build.check(rc, body)
    build.count_launch(body, B, dm.L32)
    return out


def mulmod_rows_limbs(a: torch.Tensor, b: torch.Tensor,
                      rm: cm.RowsModulus) -> torch.Tensor:
    """Kernel on a CUDA tensor, plain version on a CPU tensor."""
    if a.device.type == "cuda":
        return mulmod_rows_cuda(a, b, rm)
    return mulmod_rows_plain(a, b, rm)


def mulmod_limbs(a: torch.Tensor, b: torch.Tensor,
                 dm: cm.DeviceModulus) -> torch.Tensor:
    """Kernel on a CUDA tensor, plain version on a CPU tensor."""
    if a.device.type == "cuda":
        return mulmod_cuda(a, b, dm)
    return mulmod_plain(a, b, dm)
