"""Quantization Gamma_1 / Gamma_2 and Theorem-1 dequantization (paper §III-A).

Port of ``repro.core.quantization``: the same float64 formulas in eager
torch on the host (the reference relied on JAX x64; here the dtype is
explicit).  Results go straight to the host protocol loop, so every
function returns numpy.  Eager torch float64 reproduces the reference's
jnp results bit for bit on these elementwise formulas, once subnormals
are handled as the reference's backend handles them: XLA's CPU backend
flushes subnormal float64 operands and results to zero (keeping the sign
of zero), eager torch keeps them, so every operation here goes through
:func:`flush_subnormal`.

    Gamma_2(u) = round( Delta   (u - zmin) / (zmax - zmin)   )   in {0..Delta}
    Gamma_1(u) = round( Delta^2 (u - zmin) / (zmax - zmin)^2 )   in {0..Delta^2/s}

and the exact N-dimensional Theorem-1 correction

    u3 + B(u1+u2) = R s^2/Delta^2
                    + zmin * (1 + 2 * B@1 + sum(u1+u2)) - 2 N zmin^2 .
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

DEFAULT_DELTA = 1.0e6
_TINY = torch.finfo(torch.float64).tiny    # smallest normal float64


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Protocol-level quantization parameters (shared by master and edges)."""
    delta: float = DEFAULT_DELTA
    zmin: float = -16.0
    zmax: float = 16.0

    @property
    def span(self) -> float:
        return self.zmax - self.zmin

    def int64_safe(self, n_dim: int) -> bool:
        """True if the Theorem-1 integer chain fits int64 for N=n_dim."""
        return 2.0 * n_dim * self.delta ** 2 < 2.0 ** 62

    def plaintext_bits(self, n_dim: int) -> int:
        """Upper bound on the homomorphic-result bit length (Remark 2)."""
        return int(np.ceil(np.log2(2.0 * n_dim * self.delta ** 2 + 1)))


def _f64(u) -> torch.Tensor:
    return torch.as_tensor(np.asarray(u, dtype=np.float64))


def flush_subnormal(x):
    """Subnormal float64 values (a tensor's or a Python float) to zero of
    the same sign; every other value unchanged.  Applied to the operands
    and the result of each float64 operation, it reproduces a backend
    that flushes subnormals (XLA's CPU backend, which the reference runs
    on)."""
    if isinstance(x, torch.Tensor):
        return torch.where(x.abs() < _TINY, x * 0.0, x)
    return x * 0.0 if abs(x) < _TINY else x


_ftz = flush_subnormal


def _affine(u, shift: float, scale: float, div: float) -> torch.Tensor:
    """``scale * (u - shift) / div`` in float64, one flushed op at a time."""
    d = _ftz(_ftz(_f64(u)) - _ftz(shift))
    return _ftz(_ftz(_ftz(scale) * d) / _ftz(div))


def _to_int64(q: torch.Tensor) -> np.ndarray:
    """float64 -> int64 as the reference's ``astype(jnp.int64)`` converts
    (XLA): a value beyond the int64 range saturates and NaN gives 0.
    (A bare ``Tensor.to(torch.int64)`` gives -2^63 for all three; Gamma_1
    at Delta = 1e15, the paper's quantizer, reaches 1e28.)"""
    hi, lo, nan = q >= 2.0 ** 63, q < -2.0 ** 63, torch.isnan(q)
    out = torch.where(hi | lo | nan, 0.0, q).to(torch.int64)
    out = torch.where(hi, torch.iinfo(torch.int64).max, out)
    return torch.where(lo, torch.iinfo(torch.int64).min, out).numpy()


def gamma2(u, spec: QuantSpec) -> np.ndarray:
    """Gamma_2: reals -> {0..Delta} (eq. 14b-d), int64."""
    return _to_int64(torch.round(_affine(u, spec.zmin, spec.delta,
                                         spec.span)))


def gamma1(u, spec: QuantSpec) -> np.ndarray:
    """Gamma_1: reals -> {0..Delta^2/s} (eq. 14a), int64."""
    return _to_int64(torch.round(_affine(u, spec.zmin, spec.delta ** 2,
                                         spec.span ** 2)))


def inv_gamma2(q, spec: QuantSpec) -> np.ndarray:
    """Gamma_2^{-1}: codes -> reals, ``q * span / Delta + zmin``."""
    x = _ftz(_ftz(_ftz(_f64(q)) * _ftz(spec.span)) / _ftz(spec.delta))
    return _ftz(x + _ftz(spec.zmin)).numpy()


def inv_gamma1(q, spec: QuantSpec) -> np.ndarray:
    """Gamma_1^{-1}: codes -> reals, ``q * span^2 / Delta^2 + zmin``."""
    x = _ftz(_ftz(_ftz(_f64(q)) * _ftz(spec.span ** 2))
             / _ftz(spec.delta ** 2))
    return _ftz(x + _ftz(spec.zmin)).numpy()


def chain(u3, B, u1, u2, spec: QuantSpec) -> np.ndarray:
    """The quantized integer chain R = G1(u3) + G2(B) @ (G2(u1) + G2(u2)).

    Exactly the plaintext the homomorphic evaluation (eq. 18) produces
    under the ciphertext (int64, wrapping as the reference's does)."""
    w = gamma2(u1, spec) + gamma2(u2, spec)
    return gamma1(u3, spec) + gamma2(B, spec) @ w


def dequantize_theorem1(R, B_row_sums, w_sum, n_dim: int,
                        spec: QuantSpec) -> np.ndarray:
    """Recover  u3 + B(u1+u2)  from the integer chain value R (Theorem 1).

    ``B_row_sums``: real row sums B @ 1 (known to the master from init phase).
    ``w_sum``: scalar sum of the real (u1 + u2) vector.
    """
    s = spec.span
    a = _ftz(_ftz(_ftz(_f64(R)) * _ftz(s ** 2)) / _ftz(spec.delta ** 2))
    b = _ftz(_ftz(2.0 * _ftz(_f64(B_row_sums))) + 1.0)
    b = _ftz(_ftz(spec.zmin) * _ftz(b + _ftz(w_sum)))
    return _ftz(_ftz(a + b) - _ftz(2.0 * n_dim * spec.zmin ** 2)).numpy()


def gamma2_saturation(q, spec: QuantSpec) -> tuple[int, int]:
    """``(clipped, total)``: entries of a Gamma_2 code vector outside the
    code range ``[0, Delta]`` (the fixed clipping contract violated)."""
    q = np.asarray(q)
    clipped = int(np.count_nonzero((q < 0) | (q > spec.delta)))
    return clipped, int(q.size)


def gamma1_saturation(q, spec: QuantSpec) -> tuple[int, int]:
    """Same counters for a Gamma_1 code vector, whose code range is
    ``[0, Delta^2 / span]``."""
    q = np.asarray(q)
    hi = spec.delta ** 2 / spec.span
    clipped = int(np.count_nonzero((q < 0) | (q > hi)))
    return clipped, int(q.size)


def quantize_tensor(u, spec: QuantSpec):
    """Plain per-tensor Gamma_2 with its own min/max (eq. 14 as printed);
    the gradient-compression quantizer.  Returns ``(q, tmin, tmax)``: int64
    codes and the float64 range (0-d arrays)."""
    u = _ftz(_f64(u))
    tmin, tmax = torch.min(u), torch.max(u)
    span = torch.clamp(_ftz(tmax - tmin), min=1e-30)
    q = torch.round(_ftz(_ftz(spec.delta * _ftz(u - tmin)) / span))
    return _to_int64(q), tmin.numpy(), tmax.numpy()


def dequantize_tensor(q, tmin, tmax, spec: QuantSpec) -> np.ndarray:
    """Inverse of :func:`quantize_tensor`: ``q * span / Delta + tmin``."""
    tmin, tmax = _ftz(_f64(tmin)), _ftz(_f64(tmax))
    span = torch.clamp(_ftz(tmax - tmin), min=1e-30)
    x = _ftz(_ftz(_ftz(_f64(q)) * span) / _ftz(spec.delta))
    return _ftz(x + tmin).numpy()
