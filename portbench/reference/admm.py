"""Plain reference of the encrypted LASSO iteration (Algorithm 1), and
the comparison that decides a LASSO cell's ``correct`` (:func:`judge`).

What the port's decrypted iterates must equal: the integer chain that
Paillier's homomorphism carries, worked out in the clear with NumPy and
Python ints, from the same A and y the benchmark hands the program.  No
key, ciphertext or kernel is involved: decryption of the edge's
eq. (13) result is exactly R = Gamma_1(u3_k) + Gamma_2(rho B_k)
(Gamma_2(u1_k) + Gamma_2(u2_k)) while R stays below n (Remark 2).

Per edge k (column block A_k, Nk = N / K columns):

* init: B_k = (A_k^T A_k + rho I)^{-1}, the codes Gamma_2(rho B_k) and the
  row sums (rho B_k) 1; u3_k = B_k A_k^T (y / K), shared as Gamma_1(u3_k);
* each round: u1 = z_k, u2 = -v_k; R as above in exact integers;
  x_k = Theorem 1's dequantization of R;
* then the master's Jacobi update: z = S_{lam/rho}(v + x_prev),
  v = v + x_prev - z, x_prev = x.

The float arithmetic follows the program's order operation by operation,
and flushes subnormal operands and results to zero as the program does
(a frozen copy of its quantizer and shrinkage), so a sound run equals
this history bit for bit.  ``dtype`` computes every float step in another
precision: float32 is the benchmark's control.
"""
from __future__ import annotations

import numpy as np


class _Floats:
    """Float arithmetic of one dtype, subnormals flushed to zero."""

    def __init__(self, dtype):
        self.dtype = np.dtype(dtype)
        self.tiny = np.finfo(self.dtype).tiny

    def __call__(self, x):
        x = np.asarray(x, self.dtype)
        return np.where(np.abs(x) < self.tiny, x * self.dtype.type(0.0), x)

    def to_int64(self, q):
        """Rounded floats to int64, saturating beyond its range, NaN to 0."""
        q = np.asarray(q, np.float64)
        hi, lo, nan = q >= 2.0 ** 63, q < -2.0 ** 63, np.isnan(q)
        out = np.where(hi | lo | nan, 0.0, q).astype(np.int64)
        out = np.where(hi, np.iinfo(np.int64).max, out)
        return np.where(lo, np.iinfo(np.int64).min, out)

    def affine(self, u, shift, scale, div):
        f = self
        d = f(f(u) - f(shift))
        return f(f(f(scale) * d) / f(div))

    def gamma2(self, u, delta, zmin, span):
        return self.to_int64(np.round(self.affine(u, zmin, delta, span)))

    def gamma1(self, u, delta, zmin, span):
        return self.to_int64(np.round(self.affine(u, zmin, delta ** 2,
                                                  span ** 2)))

    def dequantize(self, R, row_sums, w_sum, nk, delta, zmin, span):
        f = self
        a = f(f(f(R) * f(span ** 2)) / f(delta ** 2))
        b = f(f(2.0 * f(row_sums)) + 1.0)
        b = f(f(zmin) * f(b + f(w_sum)))
        return f(f(a + b) - f(2.0 * nk * zmin ** 2))

    def shrink(self, x, t):
        f = self
        x = f(x)
        d = f(np.abs(x) - f(t))
        sign = np.where(x > 0, 1.0, np.where(x < 0, -1.0, x))
        return f(sign * (np.maximum(d, 0.0) + 0.0))


def lasso_history(A, y, *, K: int, rho: float, lam: float, delta: float,
                  zmin: float, zmax: float, rounds: int,
                  dtype=np.float64) -> tuple[np.ndarray, int]:
    """``(history, code_bits)``: the iterate after each of ``rounds``
    rounds, shape (rounds, N), and the widest Gamma_2(rho B_k) code in
    bits (the matvec's exponent width).

    Raises if a code leaves its range: the chain then wraps mod n in the
    program and no plaintext reference applies."""
    f = _Floats(dtype)
    dt = f.dtype
    A = np.asarray(A, dt)
    y = np.asarray(y, dt)
    N = A.shape[1]
    if N % K:
        raise ValueError(f"N = {N} does not split over K = {K} edges")
    nk = N // K
    span = zmax - zmin
    ys = y / K
    G, row_sums, alpha = [], [], []
    for k in range(K):
        Ak = A[:, k * nk:(k + 1) * nk]
        Bk = np.linalg.inv(Ak.T @ Ak + rho * np.eye(nk, dtype=dt))
        Ck = Bk * rho
        G.append(f.gamma2(Ck, delta, zmin, span))
        row_sums.append(Ck @ np.ones(nk, dtype=dt))
        alpha.append(f.gamma1(Bk @ (Ak.T @ ys), delta, zmin, span))
    for g, a in zip(G, alpha):
        if g.min() < 0 or g.max() > delta or a.min() < 0 \
                or a.max() > delta ** 2 / span:
            raise ValueError("a Gamma code left its range")
    code_bits = max(int(g.max()).bit_length() for g in G)
    G = [g.astype(object) for g in G]
    alpha = [a.astype(object) for a in alpha]
    x_prev, z, v = (np.zeros(N, dt) for _ in range(3))
    history = np.zeros((rounds, N), dt)
    for t in range(rounds):
        x_new = np.zeros(N, dt)
        for k in range(K):
            sl = slice(k * nk, (k + 1) * nk)
            u1, u2 = z[sl], -v[sl]
            w = f.gamma2(u1, delta, zmin, span) + f.gamma2(u2, delta, zmin,
                                                          span)
            if w.min() < 0 or w.max() > 2 * delta:
                raise ValueError("a Gamma_2 code left its range")
            w_sum = np.sum(u1 + u2)
            R = alpha[k] + G[k] @ w.astype(object)
            x_new[sl] = f.dequantize(np.array(R, dtype=object).astype(dt),
                                     row_sums[k], w_sum, nk, delta, zmin,
                                     span)
        z_new = f.shrink(v + x_prev, lam / rho)
        v = v + x_prev - z_new
        z = z_new
        x_prev = x_new
        history[t] = x_new
    return history.astype(np.float64), code_bits


def judge(outcome, config: dict) -> dict:
    """Every tenant's iterates against :func:`lasso_history`'s, bit for
    bit: the verdict of a LASSO cell, and the inputs its rooflines read
    (an edge's block ``nk``, the key and the widest Gamma_2 code)."""
    gap, short, failed, bits = 0.0, 0, 0, 0
    for ten in outcome.tenants:
        want, code_bits = lasso_history(
            ten.A, ten.y, K=config["K"], rho=config["rho"],
            lam=config["lam"], delta=config["delta"], zmin=config["zmin"],
            zmax=config["zmax"], rounds=outcome.rounds)
        bits = max(bits, code_bits)
        got = np.asarray(ten.history, np.float64)
        rows = min(len(got), len(want))
        short += outcome.rounds - rows
        diff = np.abs(got[:rows] - want[:rows])
        diff[np.isnan(diff)] = np.inf
        if diff.size:
            gap = max(gap, float(diff.max()))
        failed += int(np.count_nonzero(diff.max(axis=1) > 0)) \
            + outcome.rounds - rows
    checks = {"history_gap": {"value": gap, "limit": 0.0},
              "rounds_missing": {"value": short, "limit": 0}}
    return {"correct": gap <= 0.0 and short == 0,
            "attempted": len(outcome.tenants) * outcome.rounds,
            "failed": failed, "checks": checks,
            "inputs": {"nk": config["N"] // config["K"],
                       "key_bits": config["key_bits"], "code_bits": bits}}
