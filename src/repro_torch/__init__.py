"""repro_torch: the 3P-ADMM-PC2 privacy protocol on PyTorch and CUDA.

A port of the JAX package ``repro`` for one NVIDIA H100.  The big-integer
kernels (``kernels/csrc``) are CUDA C++ written for ``sm_90a``, built at
first use and loaded with ``ctypes``; everything around them is plain
PyTorch, numpy or Python.  The public limb layout is the reference's
(radix-2^16 limbs in int32, shape ``(B, L16)``), so arrays move between
the two packages unchanged (:mod:`repro_torch.convert`).

Entry points run on the card unless the caller passes ``device="cpu"``;
asking for ``"cuda"`` on a machine without a card raises.  Which kernel
runs is decided by where the tensor lives: a CUDA tensor launches the
hand-written kernel, a CPU tensor takes its plain PyTorch version.
"""
from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """``device`` (default ``"cuda"``) as a ``torch.device``.

    Raises when CUDA is asked for and no card is present: the port never
    falls back to the CPU on its own.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev
