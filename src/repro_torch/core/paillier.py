"""Paillier homomorphic encryption — exact Python-int "gold" path.

Implements the paper's §III-B keygen/enc/dec plus the §IV CRT decomposition
(Lemmas 1-2, eqs. 35-40): every ModExp in Z_{n^2} is split into the two
half-width spaces Z_{p^2} x Z_{q^2} with exponents reduced mod phi(p^2),
phi(q^2), and recombined via eq. (38)

    x = x' + [(x'' - x') * (p^2)^{-1} mod q^2] * p^2      (mod n^2).

Note: the paper defines L(x) = (x-1)/2 (§III-B) which is a typo for the
standard Paillier L(x) = (x-1)/n — decryption does not round-trip otherwise;
we implement the standard definition (documented in DESIGN.md §2).

Role in the pipeline: this module is the SCALAR REFERENCE — every function
here computes one element at a time with Python-int ``pow`` and is the
correctness oracle the batched fast paths are tested against:

  * ``core/paillier_vec.py`` — in-graph limb-array ciphertexts (int64
    plaintexts), the ``vec`` cipher;
  * ``core/paillier_batch.py`` — int-in/int-out batched CRT fast path used
    by the ``gold`` cipher box for batches >= 8 (same ciphertext values,
    same rng stream, no per-element ``pow``).

Both fast paths run on the ``kernels/`` big-integer kernels: public limb
radix 2^16 (``core/bigint.py`` layout), kernel-internal radix 2^8, ModExp
via a 4-bit fixed window by default (``REPRO_MODEXP_METHOD=binary`` for the
paper's Algorithm-2-style ladder).  Scalar functions below (``encrypt``,
``decrypt``, ``modexp_crt``, ``c_mul_const``, vector conveniences
``encrypt_vec``/``decrypt_vec``/``make_r_pool``) stay pow-based on purpose:
they are the gold oracle, not the hot path.
"""
from __future__ import annotations

import dataclasses
import math
import random
from typing import Iterable, Sequence

# ---------------------------------------------------------------------------
# Miller-Rabin primality + prime generation (no external deps)
# ---------------------------------------------------------------------------

_SMALL_PRIMES = [2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53,
                 59, 61, 67, 71, 73, 79, 83, 89, 97]


def is_probable_prime(n: int, rng: random.Random, rounds: int = 40) -> bool:
    if n < 2:
        return False
    for p in _SMALL_PRIMES:
        if n % p == 0:
            return n == p
    d, s = n - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    for _ in range(rounds):
        a = rng.randrange(2, n - 1)
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = (x * x) % n
            if x == n - 1:
                break
        else:
            return False
    return True


def gen_prime(bits: int, rng: random.Random) -> int:
    """Random prime with exactly ``bits`` bits."""
    while True:
        cand = rng.getrandbits(bits) | (1 << (bits - 1)) | 1
        if is_probable_prime(cand, rng):
            return cand


# ---------------------------------------------------------------------------
# Key material
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PaillierKey:
    """Public (n, g) + private (lam, mu) key with CRT precomputations."""
    # public
    n: int
    g: int
    n2: int
    # private
    p: int
    q: int
    lam: int          # epsilon in the paper: lcm(p-1, q-1)
    mu: int           # (L(g^lam mod n^2))^{-1} mod n
    # CRT spaces (paper eq. 35): moduli and totients
    p2: int
    q2: int
    phi_p2: int       # p(p-1)
    phi_q2: int       # q(q-1)
    p2_inv_q2: int    # (p^2)^{-1} mod q^2  (Lemma 2 / Bezout)

    @property
    def key_bits(self) -> int:
        return self.n.bit_length()


def _L(x: int, n: int) -> int:
    return (x - 1) // n


def keygen(bits: int, rng: random.Random | None = None,
           g: int | None = None) -> PaillierKey:
    """Generate a Paillier key with an n of ~``bits`` bits.

    ``g`` defaults to n+1 (one fewer ModExp at encryption; any valid g in
    Z*_{n^2} with gcd(L(g^lam), n) = 1 is accepted, as in the paper).
    """
    rng = rng or random.Random()
    while True:
        p = gen_prime(bits // 2, rng)
        q = gen_prime(bits - bits // 2, rng)
        if p == q:
            continue
        n = p * q
        if math.gcd(n, (p - 1) * (q - 1)) != 1:
            continue
        break
    n2 = n * n
    lam = math.lcm(p - 1, q - 1)
    g = n + 1 if g is None else g
    mu_inv = _L(pow(g, lam, n2), n) % n
    if math.gcd(mu_inv, n) != 1:
        raise ValueError("invalid generator g: L(g^lam) not invertible mod n")
    mu = pow(mu_inv, -1, n)
    p2, q2 = p * p, q * q
    return PaillierKey(
        n=n, g=g, n2=n2, p=p, q=q, lam=lam, mu=mu,
        p2=p2, q2=q2, phi_p2=p * (p - 1), phi_q2=q * (q - 1),
        p2_inv_q2=pow(p2, -1, q2),
    )


def rand_r(key: PaillierKey, rng: random.Random) -> int:
    """Random r in Z*_n used as encryption blinding."""
    while True:
        r = rng.randrange(1, key.n)
        if math.gcd(r, key.n) == 1:
            return r


# ---------------------------------------------------------------------------
# Encryption / decryption (direct, eqs. 15 / 29)
# ---------------------------------------------------------------------------

def encrypt(key: PaillierKey, m: int, r: int) -> int:
    """c = g^m r^n mod n^2. Requires 0 <= m < n."""
    if not 0 <= m < key.n:
        raise ValueError("plaintext out of range [0, n)")
    if key.g == key.n + 1:
        gm = (1 + m * key.n) % key.n2  # (n+1)^m = 1 + mn (mod n^2)
    else:
        gm = pow(key.g, m, key.n2)
    return (gm * pow(r, key.n, key.n2)) % key.n2


def decrypt(key: PaillierKey, c: int) -> int:
    """m = L(c^lam mod n^2) * mu mod n (eq. 29 with the corrected L)."""
    return (_L(pow(c, key.lam, key.n2), key.n) * key.mu) % key.n


# ---------------------------------------------------------------------------
# CRT-decomposed ModExp (the paper's GPU decomposition, eqs. 35-40)
# ---------------------------------------------------------------------------

def crt_split_exp(key: PaillierKey, e: int) -> tuple[int, int]:
    """Exponent reduced into the two half-spaces (eq. 35c-h)."""
    return e % key.phi_p2, e % key.phi_q2


def crt_combine(key: PaillierKey, xp: int, xq: int) -> int:
    """Recombine x' (mod p^2), x'' (mod q^2) -> x (mod n^2) per eq. (38)."""
    return (xp + ((xq - xp) * key.p2_inv_q2 % key.q2) * key.p2) % key.n2


def modexp_crt(key: PaillierKey, base: int, e: int) -> int:
    """base^e mod n^2 computed via the two half-width spaces."""
    ep, eq = crt_split_exp(key, e)
    xp = pow(base % key.p2, ep, key.p2)
    xq = pow(base % key.q2, eq, key.q2)
    return crt_combine(key, xp, xq)


def encrypt_crt(key: PaillierKey, m: int, r: int) -> int:
    """Encryption with every ModExp CRT-decomposed (paper's optimized EP)."""
    if key.g == key.n + 1:
        gm = (1 + m * key.n) % key.n2
    else:
        gm = modexp_crt(key, key.g, m)
    return (gm * modexp_crt(key, r, key.n)) % key.n2


def decrypt_crt(key: PaillierKey, c: int) -> int:
    """Decryption with c^lam computed via CRT (paper's optimized DP)."""
    return (_L(modexp_crt(key, c, key.lam), key.n) * key.mu) % key.n


# ---------------------------------------------------------------------------
# Homomorphic operators (Definitions 1 & 2)
# ---------------------------------------------------------------------------

def c_add(key: PaillierKey, c1: int, c2: int) -> int:
    """Ciphertext addition  ⊕ : Enc(a) ⊕ Enc(b) = Enc(a+b mod n)."""
    return (c1 * c2) % key.n2


def c_mul_const(key: PaillierKey, c: int, k: int) -> int:
    """Plaintext-constant multiply ⊗ : k ⊗ Enc(a) = Enc(k*a mod n)."""
    return pow(c, k, key.n2)


def c_mul_const_crt(key: PaillierKey, c: int, k: int) -> int:
    """⊗ with the ModExp CRT-decomposed (requires private key holder)."""
    return modexp_crt(key, c, k)


# ---------------------------------------------------------------------------
# Vector conveniences for the protocol layer
# ---------------------------------------------------------------------------

def encrypt_vec(key: PaillierKey, ms: Sequence[int], rng: random.Random,
                crt: bool = False) -> list[int]:
    enc = encrypt_crt if crt else encrypt
    return [enc(key, int(m), rand_r(key, rng)) for m in ms]


def decrypt_vec(key: PaillierKey, cs: Iterable[int], crt: bool = False) -> list[int]:
    dec = decrypt_crt if crt else decrypt
    return [dec(key, int(c)) for c in cs]


def make_r_pool(key: PaillierKey, count: int, rng: random.Random) -> list[int]:
    """Precompute r^n mod n^2 blinding factors (amortized into T_pre)."""
    return [pow(rand_r(key, rng), key.n, key.n2) for _ in range(count)]
