"""ModExp over a batch — the CUDA kernels and their plain versions.

Port of ``repro.kernels.modexp``:

* ``modexp`` (``modexp_pallas``): one exponent per element, constant-time
  ladder; ``method`` "binary" (2 products per bit) or "win4" (4-bit
  windows, oblivious table select), ``reduce_impl`` "barrett" or
  "montgomery" — the four bodies of ``csrc/modexp.cu``;
* ``modexp_fixed`` (``modexp_fixed_pallas``): one host-known exponent for
  the whole batch, given as its MSB-first 4-bit windows
  (``montgomery.exp_windows``); Barrett or Montgomery
  (``csrc/modexp_fixed.cu``).  :func:`modexp_fixed_pair_cuda` runs both
  CRT halves of a Paillier exponentiation in one Montgomery launch.

``modexp_rows`` (the reference's jitted ``ops.modexp_rows``, not a Pallas
kernel) takes one modulus per row from a table
(:class:`common.RowsModulus`), Montgomery (each row's -m^{-1}, R and R^2
from the table) or Barrett, either ladder: :func:`modexp_rows_cuda`
launches the four ``modexp_rows_kernel`` bodies of ``csrc/modexp.cu``,
:func:`modexp_rows_plain` runs the same ladders over the gathered per-row
moduli.

Every body runs a group of threads per big integer;
``geometry.launch_geometry`` sizes every launch.  Each
``*_limbs`` function picks by where the base lives: a CUDA tensor
launches the kernel (or raises), a CPU tensor takes the plain version.
"""
from __future__ import annotations

from typing import Sequence

import torch

from . import build, geometry
from . import common as cm
from . import montgomery as mg

METHODS = ("binary", "win4")
REDUCE_IMPLS = ("barrett", "montgomery")


def modexp_plain(base: torch.Tensor, exp: torch.Tensor, dm: cm.DeviceModulus,
                 method: str, reduce_impl: str) -> torch.Tensor:
    """base (B, L16), exp (B, Le16) radix-2^16 -> base^exp mod m, (B, L16)."""
    if reduce_impl == "montgomery":
        return mg.modexp_mont(base, exp, dm, method)
    ladder = cm.ladder_win4 if method == "win4" else cm.ladder_binary
    return cm.barrett_ladder(ladder, base, exp, dm)


def modexp_fixed_plain(base: torch.Tensor, windows: Sequence[int],
                       dm: cm.DeviceModulus,
                       reduce_impl: str) -> torch.Tensor:
    """base^e mod m for one exponent given by its MSB-first 4-bit windows."""
    if reduce_impl == "montgomery":
        return mg.modexp_mont_fixed(base, windows, dm)
    return cm.barrett_ladder(cm.ladder_fixed, base, windows, dm)


def _field_args(dm: cm.DeviceModulus, mont: bool):
    if mont:
        return dm.mw.data_ptr(), dm.r1.data_ptr(), dm.r2.data_ptr(), dm.mp
    return dm.mw.data_ptr(), dm.muw.data_ptr(), dm.mw.data_ptr(), 0


def modexp_cuda(base: torch.Tensor, exp: torch.Tensor, dm: cm.DeviceModulus,
                method: str, reduce_impl: str,
                tpi: int | None = None) -> torch.Tensor:
    """The ``csrc/modexp.cu`` kernel on CUDA tensors (same contract).
    ``tpi`` times another instantiated group size than the launch
    geometry's own (``geometry.launch_geometry``)."""
    base = base.to(torch.int32).contiguous()
    exp = exp.to(device=base.device, dtype=torch.int32).contiguous()
    B, le16 = base.shape[0], exp.shape[1]
    build.require_rows("modexp base", base, B, dm.L16)
    build.require_rows("modexp exp", exp, B, le16)
    out = torch.empty((B, dm.L16), dtype=torch.int32, device=base.device)
    if B == 0:
        return out
    body = geometry.body_name("modexp", reduce_impl, method)
    g = geometry.launch_geometry(body, B, dm.L32, tpi)
    mont = reduce_impl == "montgomery"
    launch = build.launcher("modexp")
    with torch.cuda.device(base.device):
        rc = launch(base.data_ptr(), exp.data_ptr(), out.data_ptr(), B,
                    dm.L16, le16, *_field_args(dm, mont), dm.L32, int(mont),
                    int(method == "win4"), g.tpi, g.words, g.threads,
                    g.blocks, g.smem,
                    torch.cuda.current_stream(base.device).cuda_stream)
    build.check(rc, body)
    build.count_launch(body, B, dm.L32)
    return out


def _require_odd(rm: cm.RowsModulus, reduce_impl: str) -> None:
    if reduce_impl == "montgomery" and not rm.montgomery:
        raise ValueError("modexp_rows: Montgomery needs every table "
                         "modulus odd")


def modexp_rows_plain(base: torch.Tensor, exp: torch.Tensor,
                      rm: cm.RowsModulus, method: str,
                      reduce_impl: str) -> torch.Tensor:
    """base (B, L16), exp (B, Le16) -> base^exp mod row i's modulus,
    (B, L16), plain PyTorch."""
    _require_odd(rm, reduce_impl)
    return modexp_plain(base, exp, rm.per_row(), method, reduce_impl)


def modexp_rows_cuda(base: torch.Tensor, exp: torch.Tensor,
                     rm: cm.RowsModulus, method: str, reduce_impl: str,
                     tpi: int | None = None,
                     threads: int | None = None) -> torch.Tensor:
    """The ``modexp_rows_kernel`` of ``csrc/modexp.cu`` on CUDA tensors
    (same contract as :func:`modexp_rows_plain`).  ``tpi`` and
    ``threads`` time another group and block size than the launch
    geometry's own (``geometry.launch_geometry``)."""
    base = base.to(torch.int32).contiguous()
    exp = exp.to(device=base.device, dtype=torch.int32).contiguous()
    dm = rm.table
    B, le16 = base.shape[0], exp.shape[1]
    build.require_rows("modexp_rows base", base, B, dm.L16)
    build.require_rows("modexp_rows exp", exp, B, le16)
    _require_odd(rm, reduce_impl)
    mont = reduce_impl == "montgomery"
    midx = build.require_index("modexp_rows", rm, B, base.device)
    out = torch.empty((B, dm.L16), dtype=torch.int32, device=base.device)
    if B == 0:
        return out
    body = geometry.body_name("modexp_rows", reduce_impl, method)
    g = geometry.launch_geometry(body, B, dm.L32, tpi, threads)
    field = (dm.r1, dm.r2, dm.mp) if mont else (dm.muw, dm.mw, dm.mw)
    launch = build.launcher("modexp_rows")
    with torch.cuda.device(base.device):
        rc = launch(base.data_ptr(), exp.data_ptr(), out.data_ptr(), B,
                    dm.L16, le16, dm.mw.data_ptr(),
                    *(x.data_ptr() for x in field), midx.data_ptr(), dm.L32,
                    int(mont), int(method == "win4"), g.tpi, g.words,
                    g.threads, g.blocks, g.smem,
                    torch.cuda.current_stream(base.device).cuda_stream)
    build.check(rc, body)
    build.count_launch(body, B, dm.L32)
    return out


def _check_windows(windows: Sequence[int]) -> None:
    if not windows or min(windows) < 0 or max(windows) > 15:
        raise ValueError("modexp_fixed needs 4-bit windows (e > 0)")


def _launch_fixed(base: torch.Tensor, B0: int, windows, dms, mont: bool,
                  tpi: int | None) -> torch.Tensor:
    """One ``csrc/modexp_fixed.cu`` launch: rows [0, B0) of ``base`` to
    the power of ``windows[0]`` mod ``dms[0]``, rows [B0, B) with
    ``windows[-1]`` mod ``dms[-1]``.  The shorter schedule is padded in
    front with zero windows, which leave the ladder's 1 unchanged."""
    dm = dms[0]
    B = base.shape[0]
    out = torch.empty((B, dm.L16), dtype=torch.int32, device=base.device)
    if B == 0:
        return out
    body = geometry.body_name("modexp_fixed",
                              "montgomery" if mont else "barrett")
    g = geometry.launch_geometry(body, B, dm.L32, tpi)
    n_win = max(len(w) for w in windows)
    win = torch.tensor([[0] * (n_win - len(w)) + list(w)
                        for w in (windows[0], windows[-1])],
                       dtype=torch.int32, device=base.device)
    halves = []
    for h, d in ((0, dms[0]), (1, dms[-1])):
        halves += [win[h].data_ptr(), *_field_args(d, mont)]
    launch = build.launcher("modexp_fixed")
    with torch.cuda.device(base.device):
        rc = launch(base.data_ptr(), out.data_ptr(), B, B0, dm.L16, n_win,
                    *halves, dm.L32, int(mont), g.tpi, g.words, g.threads,
                    g.blocks, g.smem,
                    torch.cuda.current_stream(base.device).cuda_stream)
    build.check(rc, body)
    build.count_launch(body, B, dm.L32)
    return out


def modexp_fixed_cuda(base: torch.Tensor, windows: Sequence[int],
                      dm: cm.DeviceModulus, reduce_impl: str,
                      tpi: int | None = None) -> torch.Tensor:
    """The ``csrc/modexp_fixed.cu`` kernel on CUDA tensors; ``windows``
    must be non-empty (e = 0 is answered without a launch).  ``tpi`` as
    for :func:`modexp_cuda`."""
    base = base.to(torch.int32).contiguous()
    B = base.shape[0]
    build.require_rows("modexp_fixed base", base, B, dm.L16)
    _check_windows(windows)
    return _launch_fixed(base, B, (windows,), (dm,),
                         reduce_impl == "montgomery", tpi)


def modexp_fixed_pair_cuda(bases, windows, dms,
                           tpi: int | None = None) -> tuple:
    """Both CRT halves in one Montgomery launch of the
    ``csrc/modexp_fixed.cu`` kernel: ``bases[h] ^ e_h mod dms[h]`` for
    h = 0, 1, each exponent given by its windows.  The two moduli must
    share their limb and word widths."""
    (dp, dq), (wp, wq) = dms, windows
    if (dp.L16, dp.L32) != (dq.L16, dq.L32) or dp.mp is None \
            or dq.mp is None:
        raise ValueError("modexp_fixed_pair needs two odd moduli of one "
                         "width")
    rows = []
    for name, b, d, w in (("p", bases[0], dp, wp), ("q", bases[1], dq, wq)):
        b = b.to(torch.int32).contiguous()
        build.require_rows(f"modexp_fixed_pair base_{name}", b, b.shape[0],
                           d.L16)
        _check_windows(w)
        rows.append(b)
    Bp = rows[0].shape[0]
    out = _launch_fixed(torch.cat(rows), Bp, windows, dms, True, tpi)
    return out[:Bp], out[Bp:]


def modexp_limbs(base: torch.Tensor, exp: torch.Tensor, dm: cm.DeviceModulus,
                 method: str, reduce_impl: str) -> torch.Tensor:
    """Kernel on a CUDA tensor, plain version on a CPU tensor."""
    if base.device.type == "cuda":
        return modexp_cuda(base, exp, dm, method, reduce_impl)
    return modexp_plain(base, exp, dm, method, reduce_impl)


def modexp_rows_limbs(base: torch.Tensor, exp: torch.Tensor,
                      rm: cm.RowsModulus, method: str,
                      reduce_impl: str) -> torch.Tensor:
    """Kernel on a CUDA tensor, plain version on a CPU tensor."""
    if base.device.type == "cuda":
        return modexp_rows_cuda(base, exp, rm, method, reduce_impl)
    return modexp_rows_plain(base, exp, rm, method, reduce_impl)


def modexp_fixed_limbs(base: torch.Tensor, windows: Sequence[int],
                       dm: cm.DeviceModulus,
                       reduce_impl: str) -> torch.Tensor:
    """Kernel on a CUDA tensor, plain version on a CPU tensor."""
    if not windows:                      # e == 0: everything is 1
        return cm.one_like(torch.zeros((base.shape[0], dm.L16),
                                       dtype=torch.int32, device=base.device))
    if base.device.type == "cuda":
        return modexp_fixed_cuda(base, windows, dm, reduce_impl)
    return modexp_fixed_plain(base, windows, dm, reduce_impl)


def modexp_fixed_pair_limbs(bases, windows, dms, reduce_impls) -> tuple:
    """Both CRT halves: one kernel launch on CUDA tensors when both run
    Montgomery at one width with e > 0, else one ``modexp_fixed_limbs``
    call per half (the plain versions on CPU tensors)."""
    if bases[0].device.type == "cuda" and all(windows) \
            and reduce_impls == ("montgomery", "montgomery") \
            and (dms[0].L16, dms[0].L32) == (dms[1].L16, dms[1].L32):
        return modexp_fixed_pair_cuda(bases, windows, dms)
    return tuple(modexp_fixed_limbs(b, w, d, i)
                 for b, w, d, i in zip(bases, windows, dms, reduce_impls))
