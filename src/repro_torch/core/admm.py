"""ADMM LASSO solvers: centralized, distributed (paper eq. 10), the coupled
consensus variant (beyond the paper), and the DP-ADMM baseline.

Port of ``repro.core.admm``: the single-host solvers, and
:func:`make_spmd_admm`, the reference's ``shard_map`` form with one rank
of a ``torch.distributed`` process group per edge.  Float64
linear algebra in eager torch on the tensors' device (the host for numpy
input), as the reference ran it in JAX x64: ``torch.linalg.inv``,
``einsum`` and a Python loop for ``lax.scan``.  The inverses and contractions round differently
from XLA's, so the iterates agree with the reference's to a tolerance,
not bit for bit; the elementwise :func:`soft_threshold` and
:func:`split_columns` are exact.

Note on eq. (9)/(10a): the paper's x-update prints ``A_k^T y`` although the
decoupled subproblem (8) it solves contains ``y/K``; ``y_scale`` selects
``1/K`` (mathematically consistent, default) or ``1.0`` (as printed).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from .quantization import flush_subnormal


@dataclasses.dataclass(frozen=True)
class ADMMConfig:
    rho: float = 1.0
    lam: float = 1.0
    iters: int = 100
    y_scale: str = "consistent"   # "consistent" (y/K) | "paper" (y)
    coupled: bool = False         # beyond-paper consensus coupling


def _sign(x: torch.Tensor) -> torch.Tensor:
    """jnp.sign: -1 / +1, and a zero (of either sign) or NaN as itself."""
    return torch.where(x > 0, 1.0, torch.where(x < 0, -1.0, x))


def soft_threshold(x: torch.Tensor, t: float) -> torch.Tensor:
    """S_t(x) = sign(x) max(|x| - t, 0) (eq. 4b's shrinkage operator).

    Subnormal operands and results flush to zero of the same sign, as on
    the reference's backend (XLA on the CPU), and ``max`` returns +0.0
    for a zero of either sign, as XLA's does."""
    x = flush_subnormal(x)
    d = flush_subnormal(torch.abs(x) - flush_subnormal(t))
    return flush_subnormal(_sign(x) * (torch.clamp(d, min=0.0) + 0.0))


def _f64(a) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float64)


def lasso_objective(A, y, x, lam):
    """0.5 ||y - A x||^2 + lam ||x||_1 (a 0-d float64 tensor)."""
    A, y, x = _f64(A), _f64(y), _f64(x)
    r = y - A @ x
    return 0.5 * torch.dot(r, r) + lam * torch.sum(torch.abs(x))


# ---------------------------------------------------------------------------
# Centralized ADMM (eq. 4) — the paper's accuracy gold standard
# ---------------------------------------------------------------------------

def centralized_admm(A, y, cfg: ADMMConfig):
    """Returns (x, history of per-iteration x) solving eq. (1)."""
    A, y = _f64(A), _f64(y)
    M, N = A.shape
    Bmat = torch.linalg.inv(A.T @ A + cfg.rho * torch.eye(
        N, dtype=A.dtype, device=A.device))
    Aty = A.T @ y
    x = z = v = torch.zeros(N, dtype=A.dtype, device=A.device)
    hist = []
    for _ in range(cfg.iters):
        x = Bmat @ (Aty + cfg.rho * (z - v))
        z = soft_threshold(v + x, cfg.lam / cfg.rho)
        v = v + x - z
        hist.append(x)
    return x, _stack(hist, N, A)


def _stack(hist, width, like):
    if not hist:
        return torch.zeros((0, width), dtype=like.dtype, device=like.device)
    return torch.stack(hist)


# ---------------------------------------------------------------------------
# Distributed ADMM (paper eq. 10) — single-host blocked reference
# ---------------------------------------------------------------------------

def split_columns(A: np.ndarray, K: int) -> list[np.ndarray]:
    """Column blocks A_k; N need not divide K (last block is smaller)."""
    N = A.shape[1]
    sizes = [N // K + (1 if i < N % K else 0) for i in range(K)]
    out, ofs = [], 0
    for s in sizes:
        out.append(A[:, ofs:ofs + s])
        ofs += s
    return out


def _blocks(A, y, K: int, cfg: ADMMConfig):
    """(A_k stacked (K, M, Nk), B_k = (A_k^T A_k + rho I)^{-1}, alpha_k =
    B_k A_k^T y_s) for the Jacobi solvers."""
    M, N = A.shape
    if N % K:
        raise ValueError(f"N={N} is not a multiple of K={K}; pad A first")
    Nk = N // K
    Ak = A.reshape(M, K, Nk).permute(1, 0, 2)                   # (K, M, Nk)
    eye = torch.eye(Nk, dtype=A.dtype, device=A.device)
    Bk = torch.linalg.inv(torch.einsum("kmi,kmj->kij", Ak, Ak)
                          + cfg.rho * eye)
    ys = y / K if cfg.y_scale == "consistent" else y
    alpha = torch.einsum("kij,kj->ki", Bk, torch.einsum("kmi,m->ki", Ak, ys))
    return Ak, Bk, alpha


def distributed_admm(A, y, K: int, cfg: ADMMConfig):
    """Paper's synchronous (Jacobi) distributed ADMM, blocks stacked.

    Requires N % K == 0 (callers pad); returns (x, per-iter history).
    The x-update uses the (t-1) iterates exactly as eq. (10) — this is what
    lets all K blocks run in parallel and is what the privacy protocol wraps.
    """
    A, y = _f64(A), _f64(y)
    M, N = A.shape
    Ak, Bk, alpha = _blocks(A, y, K, cfg)
    x = z = v = torch.zeros((K, N // K), dtype=A.dtype, device=A.device)
    hist = []
    for _ in range(cfg.iters):
        if cfg.coupled:
            # beyond-paper: damped Jacobi residual coupling. Each block
            # re-fits its own contribution plus a 1/K share of the global
            # residual (undamped Jacobi diverges for K > 1).
            s = torch.einsum("kmi,ki->m", Ak, x)
            r_k = torch.einsum("kmi,ki->km", Ak, x) + (y - s)[None, :] / K
            rhs = torch.einsum("kmi,km->ki", Ak, r_k) + cfg.rho * (z - v)
            x_new = torch.einsum("kij,kj->ki", Bk, rhs)
        else:
            x_new = alpha + cfg.rho * torch.einsum("kij,kj->ki", Bk, z - v)
        z_new = soft_threshold(v + x, cfg.lam / cfg.rho)        # uses x^{t-1}
        v = v + x - z_new
        x, z = x_new, z_new
        hist.append(x.reshape(N))
    return x.reshape(N), _stack(hist, N, A)


# ---------------------------------------------------------------------------
# DP-ADMM baseline: distributed ADMM + Gaussian perturbation of the shared
# primal iterate each round (privacy via noise instead of HE)
# ---------------------------------------------------------------------------

def dp_admm(A, y, K: int, cfg: ADMMConfig, sigma: float,
            noise=None, generator: torch.Generator | None = None):
    """Distributed ADMM whose published iterate is noised each round:
    x_t += sigma * n_t.

    ``noise`` (iters, K, Nk) gives the standard-normal draws n_t (the
    reference draws them with ``jax.random``; passing its values makes the
    two runs comparable); without it they are drawn with ``generator``.
    """
    A, y = _f64(A), _f64(y)
    M, N = A.shape
    Ak, Bk, alpha = _blocks(A, y, K, cfg)
    shape = (cfg.iters, K, N // K)
    if noise is None:
        noise = torch.randn(shape, dtype=A.dtype, generator=generator)
    noise = _f64(noise).to(A.device)
    if tuple(noise.shape) != shape:
        raise ValueError(f"noise of shape {tuple(noise.shape)}, "
                         f"expected {shape}")
    x = z = v = torch.zeros(shape[1:], dtype=A.dtype, device=A.device)
    hist = []
    for t in range(cfg.iters):
        x_new = alpha + cfg.rho * torch.einsum("kij,kj->ki", Bk, z - v)
        # the shared (published) iterate is noised — the DP mechanism
        x_new = x_new + sigma * noise[t]
        z_new = soft_threshold(v + x, cfg.lam / cfg.rho)
        v = v + x - z_new
        x, z = x_new, z_new
        hist.append(x.reshape(N))
    return x.reshape(N), _stack(hist, N, A)


# ---------------------------------------------------------------------------
# SPMD distributed ADMM: one rank of a process group per edge node
# ---------------------------------------------------------------------------

def make_spmd_admm(group, cfg: ADMMConfig, K: int):
    """The reference's ``make_spmd_admm`` over ``group``, one rank per edge.

    Returns ``run(A_k, y) -> (x_k, objs)``: each rank passes its column
    block ``A_k`` (M, N/K) and the shared ``y``, and gets its slice of x
    and the objective after every iteration (float64, on ``A_k``'s
    device).  The uncoupled (paper) form exchanges nothing but the
    diagnostics; the coupled form all-reduces the partial products
    ``A_k x`` once per iteration.
    """
    def allsum(t):
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        return t

    def run(Ak, y):
        Ak = _f64(Ak)
        y = _f64(y).to(Ak.device)
        Nk = Ak.shape[1]
        Bk = torch.linalg.inv(Ak.T @ Ak + cfg.rho * torch.eye(
            Nk, dtype=Ak.dtype, device=Ak.device))
        ys = y / K if cfg.y_scale == "consistent" else y
        AkTy = Ak.T @ ys
        x = z = v = torch.zeros(Nk, dtype=Ak.dtype, device=Ak.device)
        objs = []
        for _ in range(cfg.iters):
            if cfg.coupled:
                s = allsum(Ak @ x)
                r = Ak @ x + (y - s) / K     # damped Jacobi share
                x_new = Bk @ (Ak.T @ r + cfg.rho * (z - v))
            else:
                x_new = Bk @ (AkTy + cfg.rho * (z - v))
            z_new = soft_threshold(v + x, cfg.lam / cfg.rho)
            v_new = v + x - z_new
            # global diagnostics: objective pieces
            res = allsum(Ak @ x_new)
            l1 = allsum(torch.sum(torch.abs(x_new)).reshape(1))[0]
            objs.append(0.5 * torch.sum((y - res) ** 2) + cfg.lam * l1)
            x, z, v = x_new, z_new, v_new
        return x, _stack(objs, 0, Ak).reshape(-1)

    return run
