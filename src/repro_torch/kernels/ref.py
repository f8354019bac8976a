"""The plain dispatch: the kernels' plain PyTorch versions by name.

Port of ``repro.kernels.ref``, the reference's jnp oracle over the same
helpers as its Pallas kernels.  Here the oracle is each kernel's plain
version, which runs on any device; the wrappers in ``ops`` take it for
CPU tensors and ``chip_smoke.py`` holds every CUDA kernel against it on
the card.  (``fft_mul_ref``, the paper's float FFT multiply, stays in the
reference as documentation only.)
"""
from __future__ import annotations

import torch

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
