"""Paillier secure aggregation — the paper's quantizer applied to an
FL-style sum, ported from ``repro.core.secure_agg``.

``paillier_aggregate``: each worker quantizes (Gamma_2-style, with the
protocol range) and encrypts its block, the blocks are ⊕-combined
(ciphertext products), and only the SUM is decrypted, so individual
contributions stay hidden.  Blocks of ``BATCH_MIN`` or more elements
encrypt and decrypt through the batched CRT path on ``device`` (the
kernels on the card); smaller blocks keep the scalar loops.  Both are
bit-identical for the same rng, and equal :func:`plain_aggregate`, the
plaintext mirror the plain cipher arm runs.

The reference's ``compressed_psum``/``compress_tree_psum`` (JAX
collectives of the LM training stack) arrive with the LM slice of the
port.
"""
from __future__ import annotations

import random
from typing import Sequence

import numpy as np

from . import paillier as gold
from . import paillier_batch as pb
from .quantization import QuantSpec


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
