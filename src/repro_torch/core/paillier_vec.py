"""Batched Paillier on the limb kernels.

Port of ``repro.core.paillier_vec``: every vector encryption, decryption
and homomorphic op is one (or a few) kernel launches over the element
batch, with the CRT decomposition (Z_{n^2} -> Z_{p^2} x Z_{q^2}) halving
operand width for the ModExp-heavy decryption path.  Functions take and
return radix-2^16 int32 limb tensors (``core.bigint`` layout) on the
device of their inputs, bit-exact vs. the Python-int gold path
(``core.paillier``).  The reference jit-compiled each body per key; here
the bodies run eagerly.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import bigint as bi
from . import paillier as gold
from ..kernels import ops
from ..obs import metrics as obs_metrics


def int64_to_limbs(x: torch.Tensor, n_limbs: int) -> torch.Tensor:
    """Nonnegative int64 tensor (B,) -> (B, n_limbs) 16-bit limbs."""
    x = torch.as_tensor(x, dtype=torch.int64)
    shifts = torch.arange(n_limbs, dtype=torch.int64, device=x.device) * 16
    return ((x[..., None] >> shifts) & 0xFFFF).to(torch.int32)


def limbs_to_int64(limbs: torch.Tensor) -> torch.Tensor:
    """(B, L) limbs -> int64 (values must fit 63 bits; callers guard)."""
    L = min(limbs.shape[-1], 4)
    shifts = torch.arange(L, dtype=torch.int64, device=limbs.device) * 16
    return torch.sum(limbs[..., :L].to(torch.int64) << shifts, dim=-1)


@dataclasses.dataclass(frozen=True)
class VecKey:
    """Limb-packed key material for the batched path (numpy; moved to a
    device per call through :func:`_row`)."""
    key: gold.PaillierKey
    pack_n: ops.ModulusPack
    pack_n2: ops.ModulusPack
    pack_p2: ops.ModulusPack
    pack_q2: ops.ModulusPack
    n_limbs: np.ndarray          # n as L16(n2) limbs (for 1 + m*n)
    mu_limbs: np.ndarray         # Paillier mu as L16(n) limbs
    lam_p: np.ndarray            # lam mod phi(p^2), exponent limbs
    lam_q: np.ndarray            # lam mod phi(q^2)
    p2_inv_q2: np.ndarray        # (p^2)^{-1} mod q^2, L16(q2) limbs
    p2_limbs: np.ndarray         # p^2 as L16(n2) limbs
    n_inv_2k: int                # n^{-1} mod 2^{16 (L16(n)+1)} for exact L(x)
    exp_limbs_half: int          # limb count of half-space exponents


def make_vec_key(key: gold.PaillierKey) -> VecKey:
    pack_n = ops.pack_modulus(key.n)
    pack_n2 = ops.pack_modulus(key.n2)
    pack_p2 = ops.pack_modulus(key.p2)
    pack_q2 = ops.pack_modulus(key.q2)
    le = max(bi.n_limbs_for(key.phi_p2), bi.n_limbs_for(key.phi_q2))
    k_bits = 16 * (pack_n.L16 + 1)
    return VecKey(
        key=key, pack_n=pack_n, pack_n2=pack_n2, pack_p2=pack_p2,
        pack_q2=pack_q2,
        n_limbs=bi.from_int(key.n, pack_n2.L16),
        mu_limbs=bi.from_int(key.mu, pack_n.L16),
        lam_p=bi.from_int(key.lam % key.phi_p2, le),
        lam_q=bi.from_int(key.lam % key.phi_q2, le),
        p2_inv_q2=bi.from_int(key.p2_inv_q2, pack_q2.L16),
        p2_limbs=bi.from_int(key.p2, pack_n2.L16),
        n_inv_2k=pow(key.n, -1, 1 << k_bits),
        exp_limbs_half=le,
    )


def _row(limbs: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A constant limb row on ``like``'s device, broadcast to its batch."""
    if like.is_cuda:   # a copy from pageable memory waits for the stream
        obs_metrics.PROCESS.count("wait.row")
    row = torch.as_tensor(np.asarray(limbs, np.int32), device=like.device)
    return row.expand(like.shape[0], row.shape[-1])


def _one(L: int, like: torch.Tensor) -> torch.Tensor:
    one = torch.zeros((like.shape[0], L), dtype=torch.int32,
                      device=like.device)
    one[:, 0] = 1
    return one


# ---------------------------------------------------------------------------
# Encryption: c = (1 + m n) * r^n mod n^2   (g = n+1 fast path)
# ---------------------------------------------------------------------------

def encrypt_batch(vk: VecKey, m: torch.Tensor,
                  rn_limbs: torch.Tensor) -> torch.Tensor:
    """Encrypt int64 plaintexts (B,) with precomputed blindings r^n (B, L)."""
    if vk.key.g != vk.key.n + 1:
        raise NotImplementedError("batched path uses the g = n+1 fast path")
    L2 = vk.pack_n2.L16
    m_limbs = int64_to_limbs(m.to(rn_limbs.device), 4)
    gm = bi.mul(m_limbs, _row(vk.n_limbs, m_limbs), out_limbs=L2)  # m*n
    gm = bi.add(gm, _one(L2, gm))                                 # 1 + m n
    return ops.mulmod(gm, rn_limbs, vk.pack_n2)


# ---------------------------------------------------------------------------
# Decryption: m = L(c^lam mod n^2) * mu mod n, ModExp via CRT half-spaces
# ---------------------------------------------------------------------------

def crt_combine_batch(vk: VecKey, xp: torch.Tensor,
                      xq: torch.Tensor) -> torch.Tensor:
    """x' (B, Lp2), x'' (B, Lq2) -> x (B, Ln2) per eq. (38), in limb space."""
    Lq = vk.pack_q2.L16
    L2 = vk.pack_n2.L16
    # x' reduced into the q^2 space (x' < p^2 may exceed q^2 when p > q)
    xp_q = _reduce_into(xp, vk.pack_q2)
    xq_f = bi.fit(xq, Lq)
    # d = (x'' - x') mod q^2 with wrap-around correction
    neg = (bi.compare(xq_f, xp_q) < 0)[..., None]
    d0 = bi.sub(xq_f, xp_q)                     # mod 2^{16 Lq}
    d = torch.where(neg, bi.add(d0, _row(vk.pack_q2.m16, d0)), d0)
    t = ops.mulmod(d, _row(vk.p2_inv_q2, d), vk.pack_q2)
    # x = x' + t * p^2  (exact, < n^2)
    tp2 = bi.mul(t, _row(vk.p2_limbs, t), out_limbs=L2)
    return bi.add(bi.fit(xp, L2), tp2)


def decrypt_batch(vk: VecKey, c_limbs: torch.Tensor) -> torch.Tensor:
    """Ciphertext limbs (B, Ln2) -> int64 plaintexts (B,) (must fit 63
    bits; :func:`decrypt_batch_limbs` is the full-width form)."""
    return limbs_to_int64(decrypt_batch_limbs(vk, c_limbs))


def decrypt_batch_limbs(vk: VecKey, c_limbs: torch.Tensor) -> torch.Tensor:
    """Ciphertext limbs (B, Ln2) -> plaintext limbs (B, Ln), full width.

    c^lam is computed in the two half-width spaces and recombined;
    L(x) = (x-1)/n is an exact division done multiplicatively via
    n^{-1} mod 2^k.
    """
    cp = _reduce_into(c_limbs, vk.pack_p2)
    cq = _reduce_into(c_limbs, vk.pack_q2)
    lam_p = bi.to_ints(np.asarray(vk.lam_p).reshape(1, -1))[0]
    lam_q = bi.to_ints(np.asarray(vk.lam_q).reshape(1, -1))[0]
    xp, xq = ops.modexp_fixed_pair((cp, cq), (lam_p, lam_q),
                                   (vk.pack_p2, vk.pack_q2))
    x = crt_combine_batch(vk, xp, xq)                # c^lam mod n^2
    Ln = vk.pack_n.L16
    k_limbs = Ln + 1
    xm1 = bi.sub(x, _one(x.shape[-1], x))
    ninv = bi.from_int(vk.n_inv_2k, k_limbs)
    alpha = bi.mul(bi.fit(xm1, k_limbs), _row(ninv, xm1), out_limbs=k_limbs)
    return ops.mulmod(bi.fit(alpha, Ln), _row(vk.mu_limbs, alpha), vk.pack_n)


def _reduce_into(c: torch.Tensor, pack: ops.ModulusPack) -> torch.Tensor:
    """Big (B, L) value -> (B, Lpack) reduced mod pack.m via chunked fold.

    Splits c into Lpack-limb chunks and folds MSB->LSB with
    acc = acc * 2^{16 Lpack} + chunk (two mulmods per chunk) — standard
    wide-to-narrow reduction without division.
    """
    Lp = pack.L16
    B = c.shape[0]
    n_chunks = -(-c.shape[-1] // Lp)
    c = bi.fit(c, n_chunks * Lp)
    base = (1 << (16 * Lp)) % pack.m_int
    base_l = _row(bi.from_int(base, Lp), c)
    one = _row(bi.from_int(1, Lp), c)
    m_pad = bi.fit(_row(pack.m16, c), Lp + 1)
    acc = torch.zeros((B, Lp), dtype=torch.int32, device=c.device)
    for i in range(n_chunks - 1, -1, -1):
        # chunk < 2^{16 Lp} may exceed m by a large factor: Barrett it first
        chunk = ops.mulmod(c[..., i * Lp:(i + 1) * Lp], one, pack)
        acc = ops.mulmod(acc, base_l, pack)
        s = bi.add(bi.fit(acc, Lp + 1), bi.fit(chunk, Lp + 1))   # < 2m
        s = bi._cond_sub(s, m_pad)
        acc = s[..., :Lp]
    return acc


# ---------------------------------------------------------------------------
# Homomorphic operators (vectorized Definitions 1 & 2)
# ---------------------------------------------------------------------------

def c_add_batch(vk: VecKey, c1: torch.Tensor,
                c2: torch.Tensor) -> torch.Tensor:
    """Enc(a) ⊕ Enc(b): elementwise ciphertext product mod n^2."""
    return ops.mulmod(c1, c2, vk.pack_n2)


def c_mul_const_batch(vk: VecKey, c: torch.Tensor, k: torch.Tensor,
                      exp_limbs: int = 4) -> torch.Tensor:
    """k ⊗ Enc(a): per-element ciphertext^k mod n^2 (k int64 >= 0)."""
    return ops.modexp(c, int64_to_limbs(k.to(c.device), exp_limbs),
                      vk.pack_n2)


def c_matvec(vk: VecKey, K: torch.Tensor, c_vec: torch.Tensor,
             exp_limbs: int = 4) -> torch.Tensor:
    """Homomorphic matrix-vector product: out[i] = Π_j c_j^{K[i,j]} mod n^2
    — one ModExp launch over the flattened (M, N) batch, then one
    product-tree launch (the edge's eq.-13 x-hat update)."""
    M, N = K.shape
    L2 = vk.pack_n2.L16
    powed = ops.modexp(
        c_vec[None, :, :].expand(M, N, L2).reshape(M * N, L2),
        int64_to_limbs(K.reshape(-1).to(c_vec.device), exp_limbs),
        vk.pack_n2).reshape(M, N, L2)
    return mul_tree(vk, powed)


def mul_tree(vk: VecKey, cur: torch.Tensor) -> torch.Tensor:
    """Batched ciphertext product over axis 1: (R, N, L) -> (R, L).

    One launch of the product-tree kernel mod n^2 (``ops.prod_mod``:
    Montgomery with one R^N correction, Barrett under
    ``REPRO_REDUCE_IMPL=barrett``), where the reference runs a log-depth
    tree of mulmod launches; exact modular arithmetic makes the
    association bit-transparent.  N = 1 gives ``cur[:, 0]`` as it is.
    """
    return ops.prod_mod(cur, vk.pack_n2)
