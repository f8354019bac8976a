"""ModExp over a batch — the CUDA kernels and their plain versions.

Port of ``repro.kernels.modexp``:

* ``modexp`` (``modexp_pallas``): one exponent per element, constant-time
  ladder; ``method`` "binary" (2 products per bit) or "win4" (4-bit
  windows, oblivious table select), ``reduce_impl`` "barrett" or
  "montgomery" — the four bodies, one CUDA template (``csrc/modexp.cu``);
* ``modexp_fixed`` (``modexp_fixed_pallas``): one host-known exponent for
  the whole batch, given as its MSB-first 4-bit windows
  (``montgomery.exp_windows``); Barrett or Montgomery
  (``csrc/modexp_fixed.cu``).

Each ``*_limbs`` function picks by where the base lives: a CUDA tensor
launches the kernel (or raises), a CPU tensor takes the plain version.
"""
from __future__ import annotations

from typing import Sequence

import torch

from . import build
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
                method: str, reduce_impl: str) -> torch.Tensor:
    """The ``csrc/modexp.cu`` kernel on CUDA tensors (same contract)."""
    base = base.to(torch.int32).contiguous()
    exp = exp.to(device=base.device, dtype=torch.int32).contiguous()
    B, le16 = base.shape[0], exp.shape[1]
    build.require_rows("modexp base", base, B, dm.L16)
    build.require_rows("modexp exp", exp, B, le16)
    out = torch.empty((B, dm.L16), dtype=torch.int32, device=base.device)
    if B == 0:
        return out
    build.require_width(dm.L32)
    mont = reduce_impl == "montgomery"
    launch = build.launcher("modexp")
    with torch.cuda.device(base.device):
        rc = launch(base.data_ptr(), exp.data_ptr(), out.data_ptr(), B,
                    dm.L16, le16, *_field_args(dm, mont), dm.L32, int(mont),
                    int(method == "win4"),
                    torch.cuda.current_stream(base.device).cuda_stream)
    build.check(rc, "modexp")
    build.LAUNCHES["modexp"] += 1
    return out


def modexp_fixed_cuda(base: torch.Tensor, windows: Sequence[int],
                      dm: cm.DeviceModulus,
                      reduce_impl: str) -> torch.Tensor:
    """The ``csrc/modexp_fixed.cu`` kernel on CUDA tensors; ``windows``
    must be non-empty (e = 0 is answered without a launch)."""
    base = base.to(torch.int32).contiguous()
    B = base.shape[0]
    build.require_rows("modexp_fixed base", base, B, dm.L16)
    if not windows or min(windows) < 0 or max(windows) > 15:
        raise ValueError("modexp_fixed needs 4-bit windows (e > 0)")
    out = torch.empty((B, dm.L16), dtype=torch.int32, device=base.device)
    if B == 0:
        return out
    build.require_width(dm.L32)
    win = torch.tensor(list(windows), dtype=torch.int32, device=base.device)
    mont = reduce_impl == "montgomery"
    launch = build.launcher("modexp_fixed")
    with torch.cuda.device(base.device):
        rc = launch(base.data_ptr(), out.data_ptr(), B, dm.L16,
                    win.data_ptr(), win.numel(), *_field_args(dm, mont),
                    dm.L32, int(mont),
                    torch.cuda.current_stream(base.device).cuda_stream)
    build.check(rc, "modexp_fixed")
    build.LAUNCHES["modexp_fixed"] += 1
    return out


def modexp_limbs(base: torch.Tensor, exp: torch.Tensor, dm: cm.DeviceModulus,
                 method: str, reduce_impl: str) -> torch.Tensor:
    """Kernel on a CUDA tensor, plain version on a CPU tensor."""
    if base.device.type == "cuda":
        return modexp_cuda(base, exp, dm, method, reduce_impl)
    return modexp_plain(base, exp, dm, method, reduce_impl)


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
