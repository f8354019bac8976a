"""Exact big-integer limb arithmetic on torch int64.

Port of ``repro.core.bigint``.  A big integer is a little-endian row of
16-bit limbs held in int32 (``(..., L)``), the public layout shared with
the reference.  The host codecs (``from_int(s)``, ``to_int(s)``,
``barrett_mu``, ``n_limbs_for``) are the reference's numpy code,
bit-identical.  The tensor functions run on whatever device their inputs
live on; they are plain tensor code there, as they were plain jnp outside
the Pallas kernels in the reference.

Carry propagation is vectorized over limbs rather than a scan: every
limb's carry folds into the next one at once, repeated until none is
left, which takes a few rounds.  ``torch.matmul``/``einsum`` take no
int64 on CUDA, so :func:`mul` forms all partial products at once for
small operands and accumulates shifted multiply-adds over the shorter
operand for large ones.  Internals work in int64; the public functions
return int32 limbs like the reference's.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..obs import metrics as obs_metrics
from ..obs import trace

LIMB_BITS = 16
LIMB_BASE = 1 << LIMB_BITS
LIMB_MASK = LIMB_BASE - 1


# ---------------------------------------------------------------------------
# Host-side conversions (Python ints <-> limb arrays); numpy, as in repro
# ---------------------------------------------------------------------------

def from_int(x: int, n_limbs: int) -> np.ndarray:
    """Encode a nonnegative Python int as ``n_limbs`` little-endian limbs."""
    if x < 0:
        raise ValueError("bigint limbs encode nonnegative integers only")
    if x >> (LIMB_BITS * n_limbs):
        raise ValueError(f"{x.bit_length()}-bit value does not fit {n_limbs} limbs")
    out = np.zeros(n_limbs, dtype=np.int32)
    for i in range(n_limbs):
        out[i] = x & LIMB_MASK
        x >>= LIMB_BITS
    return out


@trace.spanned("paillier.pack")
def from_ints(xs, n_limbs: int) -> np.ndarray:
    """Vectorize :func:`from_int` over a flat list -> (len(xs), n_limbs)."""
    xs = [int(x) for x in xs]
    if not xs:
        return np.zeros((0, n_limbs), dtype=np.int32)
    nbytes = 2 * n_limbs
    try:
        buf = b"".join(x.to_bytes(nbytes, "little") for x in xs)
    except OverflowError:
        for x in xs:
            if x < 0:
                raise ValueError(
                    "bigint limbs encode nonnegative integers only") from None
            if x >> (LIMB_BITS * n_limbs):
                raise ValueError(f"{x.bit_length()}-bit value does not fit "
                                 f"{n_limbs} limbs") from None
        raise
    out = np.frombuffer(buf, dtype="<u2").astype(np.int32)
    return out.reshape(len(xs), n_limbs)


def to_int(limbs) -> int:
    """Decode little-endian limbs (1-D) back to a Python int."""
    arr = _host(limbs).astype(object)
    out = 0
    for i in range(arr.shape[-1] - 1, -1, -1):
        out = (out << LIMB_BITS) | int(arr[i])
    return out


@trace.spanned("paillier.unpack")
def to_ints(limbs) -> list:
    """Decode a (..., L) limb array or tensor to a flat list of Python ints
    (limbs must be normalized to [0, 2^16))."""
    arr = _host(limbs)
    flat = arr.reshape(-1, arr.shape[-1])
    if flat.shape[0] == 0:
        return []
    if flat.dtype == object:
        return [to_int(row) for row in flat]
    buf = np.ascontiguousarray(flat.astype("<u2")).tobytes()
    nbytes = 2 * flat.shape[1]
    return [int.from_bytes(buf[i * nbytes:(i + 1) * nbytes], "little")
            for i in range(flat.shape[0])]


def _host(limbs) -> np.ndarray:
    if not isinstance(limbs, torch.Tensor):
        return np.asarray(limbs)
    if not limbs.is_cuda:
        return limbs.detach().cpu().numpy()
    with trace.wait("wait.to_host"):
        return limbs.detach().cpu().numpy()


@trace.spanned("paillier.pack")
def to_device(arr, device) -> torch.Tensor:
    """A host array (numpy, or a list of ints) as a tensor on ``device``,
    without waiting for a CUDA device: through pinned memory and an
    asynchronous copy on the current stream (the caching host allocator
    keeps the pinned block until the copy has run), where
    ``torch.as_tensor(arr, device=...)`` would wait for the stream to
    drain.  The way back is :func:`to_ints`."""
    t = torch.as_tensor(np.ascontiguousarray(arr))
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def barrett_mu(m: int, n_limbs: int) -> np.ndarray:
    """Precompute ``mu = floor(B^{2L} / m)`` as ``n_limbs + 1`` limbs."""
    mu = (1 << (LIMB_BITS * 2 * n_limbs)) // m
    return from_int(mu, n_limbs + 1)


def n_limbs_for(m: int) -> int:
    """Minimum limb count holding ``m`` (at least 1)."""
    return max(1, -(-m.bit_length() // LIMB_BITS))


# ---------------------------------------------------------------------------
# Carry propagation (int64 internals; the public functions return int32)
# ---------------------------------------------------------------------------

def _i64(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.int64 else x.to(torch.int64)


def _norm(v: torch.Tensor) -> torch.Tensor:
    """Normalize int64 coefficients (any sign) to limbs in [0, 2^16),
    exact mod 2^{16 L}: fold every limb's carry into the next one until
    none is left (a few rounds; a carry chain of k limbs takes k).  On a
    card each round reads its carry test back: a wait, counted."""
    while True:
        c = v >> LIMB_BITS
        if c.is_cuda:
            obs_metrics.PROCESS.count("wait.carry")
        if not bool(c.any()):
            return v
        v = v & LIMB_MASK
        v[..., 1:] += c[..., :-1]


def carry_normalize(acc: torch.Tensor) -> torch.Tensor:
    """Normalize int64 coefficients to base-2^16 limbs (int32).

    Overflow past the last limb is dropped (exact mod 2^{16 L}), as in the
    reference.
    """
    return _norm(_i64(acc)).to(torch.int32)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Limb-wise a + b with carry propagation (overflow dropped)."""
    return _norm(_i64(a) + _i64(b)).to(torch.int32)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b mod B^L (wrap-around two's-complement-style subtraction)."""
    return _norm(_i64(a) - _i64(b)).to(torch.int32)


def compare(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise big-int compare over the last axis: -1 / 0 / +1 (int64)."""
    d = torch.sign(_i64(a) - _i64(b))
    idx = torch.arange(d.shape[-1], device=d.device).expand_as(d)
    top = torch.where(d != 0, idx, -1).amax(-1, keepdim=True)
    sgn = torch.gather(d, -1, top.clamp(min=0))
    return torch.where(top >= 0, sgn, 0)[..., 0]


# ---------------------------------------------------------------------------
# Multiplication
# ---------------------------------------------------------------------------

#: largest (batch x La x (La + Lb)) buffer the one-shot convolution builds;
#: larger products accumulate shifted multiply-adds instead
_SKEW_MAX = 1 << 26


def _conv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unnormalized product coefficients, (..., La) x (..., Lb) ->
    (..., La + Lb) int64 (the top coefficient is 0); batches broadcast."""
    la, lb = a.shape[-1], b.shape[-1]
    a, b = _i64(a), _i64(b)
    if la > lb:
        a, b, la, lb = b, a, lb, la
    if max(a[..., 0].numel(), b[..., 0].numel()) * la * (la + lb) <= _SKEW_MAX:
        # all partial products at once; row i shifted right by i through a
        # reshape with row length La + Lb - 1, then summed down the rows
        o = F.pad(a[..., :, None] * b[..., None, :], (0, la))
        o = o.flatten(-2)[..., :la * (la + lb - 1)]
        return F.pad(o.unflatten(-1, (la, la + lb - 1)).sum(-2), (0, 1))
    batch = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    acc = torch.zeros((*batch, la + lb), dtype=torch.int64, device=a.device)
    for i in range(la):
        acc[..., i:i + lb] += a[..., i:i + 1] * b
    return acc


def _mul(a: torch.Tensor, b: torch.Tensor,
         out_limbs: int | None = None) -> torch.Tensor:
    full = _norm(_conv(a, b))
    return full if out_limbs is None else fit(full, out_limbs)


def mul(a: torch.Tensor, b: torch.Tensor,
        out_limbs: int | None = None) -> torch.Tensor:
    """Exact product of limb arrays: (..., La) x (..., Lb) -> (..., out).

    ``out_limbs`` defaults to La + Lb (full product, never truncates);
    leading dimensions broadcast.
    """
    return _mul(a, b, out_limbs).to(torch.int32)


def fit(x: torch.Tensor, n: int) -> torch.Tensor:
    """Truncate or zero-pad the limb axis to ``n`` limbs."""
    L = x.shape[-1]
    if L == n:
        return x
    if L > n:
        return x[..., :n]
    return F.pad(x, (0, n - L))


def shift_right_limbs(a: torch.Tensor, k: int) -> torch.Tensor:
    """Drop the k least-significant limbs (floor-divide by B^k)."""
    return a[..., k:]


def low_limbs(a: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the k least-significant limbs (mod B^k)."""
    return a[..., :k]


# ---------------------------------------------------------------------------
# Barrett reduction and modular ops
# ---------------------------------------------------------------------------

def _cond_sub(r: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """r - m if r >= m else r (m zero-padded to r's width)."""
    return _csub(r, m).to(torch.int32)


def _csub(r: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """int64 r - m if r >= m else r, for normalized r and m (m
    zero-padded to r's width).  m is subtracted only where r >= m: a
    difference that wrapped below 0 would carry its borrow through every
    limb above, one normalizing round per limb."""
    m = fit(_i64(m), r.shape[-1])
    geq = (compare(r, m) >= 0)[..., None]
    return _norm(_i64(r) - torch.where(geq, m, 0))


def _barrett(x: torch.Tensor, m: torch.Tensor,
             mu: torch.Tensor) -> torch.Tensor:
    """int64 :func:`barrett_reduce`."""
    L = m.shape[-1]
    x = fit(_i64(x), max(x.shape[-1], 2 * L))
    q3 = _mul(x[..., L - 1:], mu)[..., L + 1:]           # L+1 limbs
    r = _norm(x[..., :L + 1] - _mul(q3, m, L + 1))       # mod B^{L+1}, < 3m
    return _csub(_csub(r, m), m)[..., :L]


def barrett_reduce(x: torch.Tensor, m: torch.Tensor,
                   mu: torch.Tensor) -> torch.Tensor:
    """x mod m for x < B^{2L}, modulus m of L limbs, mu = floor(B^{2L}/m).

    Returns L limbs.  Exact per HAC 14.42: the remainder before the two
    fixed conditional subtractions is < 3m.
    """
    return _barrett(x, m, mu).to(torch.int32)


def mulmod(a: torch.Tensor, b: torch.Tensor, m: torch.Tensor,
           mu: torch.Tensor) -> torch.Tensor:
    """(a * b) mod m, all operands of L limbs."""
    return _barrett(_mul(a, b), m, mu).to(torch.int32)


def modexp(base: torch.Tensor, exp: torch.Tensor, m: torch.Tensor,
           mu: torch.Tensor) -> torch.Tensor:
    """base^exp mod m by the constant-time binary square-and-multiply
    ladder (the reference's plain ``bigint.modexp``, not a kernel).

    ``base``: (..., L) limbs; ``exp``: (..., Le) limbs (per-element
    exponents); ``m``/``mu``: 1-D modulus limbs (broadcast) or batched.
    Returns (..., L) int32 limbs.
    """
    n_bits = exp.shape[-1] * LIMB_BITS
    exp64 = _i64(exp)
    res = torch.zeros_like(base, dtype=torch.int32)
    res[..., 0] = 1
    # reduce base mod m first (callers may pass unreduced bases)
    b = barrett_reduce(base, m, mu)
    for j in range(n_bits):
        bit = (exp64[..., j // LIMB_BITS] >> (j % LIMB_BITS)) & 1
        res = torch.where((bit == 1)[..., None], mulmod(res, b, m, mu), res)
        b = mulmod(b, b, m, mu)
    return res


def mod_small(a: torch.Tensor, m: torch.Tensor,
              mu: torch.Tensor) -> torch.Tensor:
    """a mod m for a of up to 2L limbs (general entry point)."""
    return barrett_reduce(a, m, mu)
