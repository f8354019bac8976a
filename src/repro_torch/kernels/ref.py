"""The plain dispatch: the kernels' plain PyTorch versions by name.

Port of ``repro.kernels.ref``, the reference's jnp oracle over the same
helpers as its Pallas kernels.  Here the oracle is each kernel's plain
version, which runs on any device; the wrappers in ``ops`` take it for
CPU tensors and ``chip_smoke.py`` holds every CUDA kernel against it on
the card.  :func:`fft_mul_ref`, the paper's float FFT multiply, documents
eqs. (44)-(46), as in the reference; nothing on the main path calls it.
"""
from __future__ import annotations

import torch

from ..core import bigint as bi
from .common import DeviceModulus
from .limb_mulmod import mulmod_plain as mulmod_ref  # noqa: F401
from .modexp import METHODS, REDUCE_IMPLS, modexp_plain


def modexp_ref(base: torch.Tensor, exp: torch.Tensor, dm: DeviceModulus,
               method: str = "binary",
               reduce_impl: str = "barrett") -> torch.Tensor:
    """ModExp oracle: the plain version of the (method, reduce_impl) body.
    Unknown names raise instead of silently falling back."""
    if method not in METHODS:
        raise ValueError(f"unknown modexp method {method!r}; "
                         "expected 'binary' or 'win4'")
    if reduce_impl not in REDUCE_IMPLS:
        raise ValueError(f"unknown reduce_impl {reduce_impl!r}; "
                         "expected 'barrett' or 'montgomery'")
    if reduce_impl == "montgomery" and dm.minv is None:
        raise ValueError("montgomery reduce_impl needs an odd modulus")
    return modexp_plain(base, exp, dm, method, reduce_impl)


def fft_mul_ref(a16: torch.Tensor, b16: torch.Tensor) -> torch.Tensor:
    """The paper's FFT big-int multiply (eqs. 44-46) in complex double:
    (B, La) x (B, Lb) radix-2^16 limbs -> the (B, La + Lb) limbs of the
    products.

    Each coefficient of the limb convolution is at most
    min(La, Lb) (2^16 - 1)^2, so the product is exact while the FFT's
    round-off stays below half a unit of a coefficient: at 256 limbs
    (4096-bit numbers) of 2^16 - 1 it is 1.2e-4.
    """
    la, lb = a16.shape[-1], b16.shape[-1]
    n = 1
    while n < la + lb:
        n *= 2
    fa = torch.fft.rfft(a16.to(torch.float64), n=n, dim=-1)
    fb = torch.fft.rfft(b16.to(torch.float64), n=n, dim=-1)
    coeff = torch.fft.irfft(fa * fb, n=n, dim=-1)[..., :la + lb]
    return bi.carry_normalize(torch.round(coeff).to(torch.int64))
