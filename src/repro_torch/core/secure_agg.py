"""Secure and compressed aggregation — the paper's quantizer applied to
sums across workers, ported from ``repro.core.secure_agg``.

``compressed_psum``/``compress_tree_psum``: Gamma-style integer
quantization of gradients with one shared symmetric scale, an integer
all-reduce over a ``torch.distributed`` process group (the reference's
``psum`` over a mesh axis), dequantization and error feedback.  Every
rank uses the same scale, so dequantize(sum(q)) == sum(dequantize(q)).

``paillier_aggregate``: each worker quantizes (Gamma_2-style, with the
protocol range) and encrypts its block, the blocks are ⊕-combined
(ciphertext products), and only the SUM is decrypted, so individual
contributions stay hidden.  Blocks of ``BATCH_MIN`` or more elements
encrypt and decrypt through the batched CRT path on ``device`` (the
kernels on the card); smaller blocks keep the scalar loops.  Both are
bit-identical for the same rng, and equal :func:`plain_aggregate`, the
plaintext mirror the plain cipher arm runs.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from . import paillier as gold
from . import paillier_batch as pb
from .quantization import QuantSpec


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    bits: int = 16                 # quantized integer width (8 or 16)
    enabled: bool = True
    error_feedback: bool = True


def _qmax(bits: int) -> float:
    return float(2 ** (bits - 1) - 1)


def _shared_scale(g: torch.Tensor, group) -> torch.Tensor:
    """max |g| over every rank (the reference's ``pmax``), floored."""
    s = torch.amax(torch.abs(g)).reshape(1)
    dist.all_reduce(s, op=dist.ReduceOp.MAX, group=group)
    return torch.clamp(s[0], min=1e-30)


def _quantize(g: torch.Tensor, scale: torch.Tensor, bits: int):
    return torch.round(g / scale * _qmax(bits)).to(torch.int32)


def compressed_psum(g: torch.Tensor, group=None, bits: int = 16):
    """Quantized all-reduce of a gradient tensor over ``group``.

    One MAX all-reduce sets the scale, gradients round (half to even, as
    ``jnp.round``) to ``bits``-wide ints, the int32 tensor is summed
    across ranks, and the sum is rescaled."""
    scale = _shared_scale(g, group)
    q = _quantize(g, scale, bits)
    dist.all_reduce(q, op=dist.ReduceOp.SUM, group=group)
    return q.to(g.dtype) * (scale / _qmax(bits))


def compress_tree_psum(grads, group, cfg: CompressionConfig,
                       residuals=None):
    """:func:`compressed_psum` over a sequence of gradients with error
    feedback; returns (reduced grads, new residuals) as lists.

    ``residuals`` lines up with ``grads`` (zeros when None).  Each rank's
    new residual is its corrected gradient minus its own contribution's
    round trip, so the quantization error of one step enters the next."""
    grads = list(grads)
    if not cfg.enabled:
        out = []
        for g in grads:
            g = g.clone()
            dist.all_reduce(g, op=dist.ReduceOp.SUM, group=group)
            out.append(g)
        return out, residuals
    if residuals is None:
        residuals = [torch.zeros_like(g) for g in grads]
    red, res = [], []
    qm = _qmax(cfg.bits)
    for g, r in zip(grads, residuals):
        g_corr = g + r
        scale = _shared_scale(g_corr, group)
        q = _quantize(g_corr, scale, cfg.bits)
        if cfg.error_feedback:
            own = q.to(g_corr.dtype) * (scale / qm)
            res.append(g_corr - own.to(g.dtype))
        else:
            res.append(torch.zeros_like(g))
        dist.all_reduce(q, op=dist.ReduceOp.SUM, group=group)
        red.append(q.to(g_corr.dtype) * (scale / qm))
    return red, res


def _quant_block(blk: np.ndarray, spec: QuantSpec) -> np.ndarray:
    """The worker-side Gamma_2-style affine quantization — shared verbatim
    by the encrypted path and its plaintext mirror, so the two stay
    bit-identical by construction."""
    return np.round(spec.delta * (np.clip(np.asarray(blk).reshape(-1),
                                          spec.zmin, spec.zmax)
                                  - spec.zmin) / spec.span).astype(np.int64)


def _dequant_sum(tots, Kn: int, spec: QuantSpec) -> np.ndarray:
    """sum_k (q_k s/Delta + zmin) = tot*s/Delta + K*zmin, per element."""
    out = np.empty(len(tots))
    for i, tot in enumerate(tots):
        out[i] = tot * spec.span / spec.delta + Kn * spec.zmin
    return out


def paillier_aggregate(blocks: Sequence[np.ndarray], key: gold.PaillierKey,
                       spec: QuantSpec, rng: random.Random | None = None,
                       crt: bool = True, device=None) -> np.ndarray:
    """Securely sum worker blocks: only the sum is ever decrypted.

    Each worker: q_k = Gamma_2-style quantization with the protocol range
    [zmin, zmax]; c_k = Enc(q_k).  Aggregator: C = ⊕_k c_k.  Master:
    sum = dequant(Dec(C)).  The quantized integers sum exactly under the
    homomorphism, so the result equals :func:`plain_aggregate` bit for
    bit.  ``device`` (default the card) is where the batched path runs;
    ``crt=False`` means ``gold.encrypt`` semantics, which the batched
    path (``encrypt_crt`` semantics) must not replace.
    """
    rng = rng or random.Random(0)
    Kn = len(blocks)
    n_el = blocks[0].size
    batched = n_el >= pb.BATCH_MIN and crt and key.g == key.n + 1
    bk = pb.make_batch_key(key, device) if batched else None
    enc = gold.encrypt_crt if crt else gold.encrypt
    dec = gold.decrypt_crt if crt else gold.decrypt

    agg = [1] * n_el
    for blk in blocks:
        q = _quant_block(blk, spec)
        if batched:
            cs = pb.enc_vec(bk, q, rng)
        else:
            cs = [enc(key, int(qi), gold.rand_r(key, rng)) for qi in q]
        for i, c in enumerate(cs):
            agg[i] = (agg[i] * c) % key.n2          # ⊕ accumulate
    tots = pb.dec_vec(bk, agg) if batched else [dec(key, a) for a in agg]
    return _dequant_sum(tots, Kn, spec).reshape(blocks[0].shape)


def plain_aggregate(blocks: Sequence[np.ndarray],
                    spec: QuantSpec) -> np.ndarray:
    """Bit-exact plaintext mirror of :func:`paillier_aggregate`: the same
    per-worker quantization, exact integer summation and dequantization,
    without the encryption layer."""
    Kn = len(blocks)
    n_el = blocks[0].size
    agg = [0] * n_el
    for blk in blocks:
        q = _quant_block(blk, spec)
        for i, qi in enumerate(q):
            agg[i] += int(qi)
    return _dequant_sum(agg, Kn, spec).reshape(blocks[0].shape)
