"""Row-split (sample-parallel) consensus families — "distributed data,
global model" with every edge keeping its OWN rows of A end-to-end.

The abstract claims both task decomposition *and* "multiple edge nodes
use distributed data to train a global model".  The column-split
families decompose the task; these decompose the DATA: edge k owns its
private sample block ``(A_k, y_k)`` (``A_k`` = rows ``k*Mk..(k+1)*Mk``
of A) and iterates a full-width local copy ``x_k`` of the consensus
variable,

    min_x  sum_k f_k(x; A_k, y_k) + g(x)
    <=>    min  sum_k f_k(x_k) + g(z)   s.t.  x_k = z  for all k.

Scaled consensus ADMM:

    x_k^{t+1} = argmin f_k(x) + (rho/2) ||x - z^t + v_k^t||^2
    z^{t+1}   = prox_{g/(K rho)}( xbar^{t+1} + vbar^t )
    v_k^{t+1} = v_k^t + x_k^{t+1} - z^{t+1},

which is exactly the protocol's affine ciphertext map per edge —
``u1 = z``, ``u2 = -v_k``, ``C_k = rho B_k`` — with block length N
instead of N/K (the :meth:`~repro_torch.workloads.base.Workload.dims`
row-split contract: the master's stacked iterate holds K full-width
copies).

Row split is the setting where per-node data leaks through the shared
iterates (Zhang et al., arXiv:1806.02246; Ye et al., arXiv:2003.10615
both attack it), so the z-update's cross-edge aggregate
``sum_k (x_k + v_k)`` runs through the secure-aggregation dataflow of
:func:`repro_torch.core.secure_agg.paillier_aggregate` — each block Gamma_2
quantized and encrypted exactly as its owning worker would, ⊕-combined
in ciphertext, only the SUM ever decrypted — whenever the run has key
material (the :class:`~repro_torch.workloads.base.SecureAggContext` the
protocol installs), and through the bit-exact plaintext mirror
:func:`~repro_torch.core.secure_agg.plain_aggregate` on the plain arm, so all
four cipher arms produce identical trajectories bit-for-bit
(tests/test_torch_workloads.py holds them to the reference).  Scope of the claim: this is a
single-process simulation in which the master plays every role (it also
decrypts each x_k in the base protocol), so what is modeled and
accounted is the deployment dataflow — in a real rollout, where each
edge encrypts its own block, the combine step hides individual iterates
from aggregator/relay parties; the key-holding master learns only what
the base protocol already hands it.

Families:

* ``consensus_lasso``    — f_k = 0.5||A_k x - y_k||^2, g = lam||x||_1.
  Fixed point: the CENTRALIZED lasso optimum on the pooled data
  (oracle: full-data ISTA).
* ``consensus_logistic`` — prox-linear local steps on each edge's own
  logistic loss, g = (lam/2)||x||^2.  Fixed point: ``sum_k g_k(x) +
  lam x = 0`` — the centralized L2-regularized logistic optimum
  (oracle: full-batch GD), with every gradient computed from the
  edge's OWN rows at its OWN local iterate.

Copied from ``repro.workloads.consensus`` (numpy only).
"""
from __future__ import annotations

import numpy as np

from . import register
from .base import (Workload, WorkloadInstance, WorkloadState, ista_block,
                   soft_threshold_np)
from .logistic import _sigmoid, _softplus


class ConsensusWorkload(Workload):
    """Base of the row-split families: dims/aggregation/fold machinery.

    Subclasses fill in the local loss (``edge_setup`` / ``share_vector``
    / ``iter_inputs``) and the consensus prox (``prox_consensus``)."""

    split = "row"
    uses_secure_agg = True

    # -- split-axis contract ----------------------------------------------
    def dims(self, A: np.ndarray, K: int) -> tuple[int, int]:
        """Row split: block = full model width, state stacks K copies.

        Ragged M is handled internally: ``init_state`` pads A (and y)
        with zero rows up to K | M' — zero rows are inert in every
        per-edge quantity (A_k^T A_k, A_k^T y_k, local gradients), so
        the padded iteration is bit-for-bit the unpadded math."""
        return K * A.shape[1], A.shape[1]

    def init_state(self, A, y, ys, K,
                   y_scale: str = "consistent") -> WorkloadState:
        A = np.asarray(A, np.float64)
        pad = self._pad_rows(A.shape[0], K) - A.shape[0]
        if pad:
            A = np.concatenate([A, np.zeros((pad, A.shape[1]))], axis=0)
            y = np.concatenate([np.asarray(y, np.float64), np.zeros(pad)])
            ys = np.concatenate([np.asarray(ys, np.float64), np.zeros(pad)])
        return super().init_state(A, y, ys, K, y_scale=y_scale)

    def row_sl(self, st: WorkloadState, k: int) -> slice:
        Mk = st.A.shape[0] // st.K
        return slice(k * Mk, (k + 1) * Mk)

    def fold_solution(self, x: np.ndarray, K: int,
                      n: int | None = None) -> np.ndarray:
        """Average the K full-width copies (all equal at the fixed point)."""
        xm = np.asarray(x).reshape(K, -1).mean(axis=0)
        return xm if n is None else xm[:n]

    def _fold_for_eval(self, A: np.ndarray, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x)
        n = np.asarray(A).shape[1]
        return self.fold_solution(x, x.size // n) if x.size != n else x

    # -- local quadratic block --------------------------------------------
    def edge_setup(self, st: WorkloadState, k: int):
        Ak = st.A[self.row_sl(st, k)]
        return Ak.T @ Ak, self.rho, self.rho

    def share_vector(self, st: WorkloadState, k: int,
                     Bk: np.ndarray) -> np.ndarray:
        # edge k's own observations — no 1/K rescale: the pooled
        # objective is the plain sum of the per-edge losses
        Ak = st.A[self.row_sl(st, k)]
        return Bk @ (Ak.T @ st.y[self.row_sl(st, k)])

    def iter_inputs(self, st: WorkloadState, k: int):
        sl = st.sl(k)
        return st.z[sl], -st.v[sl]

    # -- consensus global update ------------------------------------------
    def global_update(self, st: WorkloadState, x_new: np.ndarray) -> None:
        """Aggregate + prox + dual update, folded to the ACTIVE copies.

        Under churn a departed edge's copy leaves the consensus: the
        aggregate sums only active blocks and the z-prox rescales to the
        active count (its fixed point is the pooled optimum of the data
        still present); the departed copy's (z, v) slices freeze with
        its handoff block and resume on rejoin."""
        K, n = st.K, st.Nk
        act = st.aux.get("churn_active")
        stacked = (x_new + st.v).reshape(K, n)
        if act is None or act.all():
            blocks, K_act = list(stacked), K
        else:
            blocks = [stacked[k] for k in range(K) if act[k]]
            K_act = len(blocks)
        ctx = st.aux.get("secure_agg")
        if ctx is None:        # float baseline (simulate_float): plain mean
            total = np.sum(blocks, axis=0)
        else:                  # protocol: the aggregate crosses encrypted
            total = ctx.aggregate(blocks)
        z = np.asarray(self.prox_consensus(total / K_act, K_act))
        v_new = st.v + x_new - np.tile(z, K)
        z_new = np.tile(z, K)
        if act is not None and not act.all():
            m = np.repeat(np.asarray(act, bool), n)
            v_new = np.where(m, v_new, st.v)
            z_new = np.where(m, z_new, st.z)
        st.v = v_new
        st.z = z_new
        st.x_prev = x_new

    def prox_consensus(self, u: np.ndarray, K: int) -> np.ndarray:
        """prox_{g/(K rho)} — the consensus z-update."""
        raise NotImplementedError

    # -- evaluation ---------------------------------------------------------
    def metrics(self, inst: WorkloadInstance, x: np.ndarray) -> dict:
        out = {"objective": self.objective(inst.A, inst.y, x)}
        if inst.x_true is not None:
            xm = self._fold_for_eval(inst.A, x)
            out["mse_vs_truth"] = float(np.mean((xm - inst.x_true) ** 2))
        return out

    @staticmethod
    def _pad_rows(M: int, K: int) -> int:
        """Smallest M' >= M with K | M' (row split needs even row blocks)."""
        return M + (-M) % K


@register
class ConsensusLassoWorkload(ConsensusWorkload):
    name = "consensus_lasso"
    default_params = {"rho": 1.0, "lam": 0.05}

    def make_instance(self, M: int, N: int, K: int,
                      seed: int = 0, **kw) -> WorkloadInstance:
        M = self._pad_rows(M, K)
        rng = np.random.default_rng(seed)
        A = rng.normal(0.0, 1.0, (M, N)) / np.sqrt(M)
        k_nz = max(1, int(round(kw.pop("sparsity", 0.2) * N)))
        x = np.zeros(N)
        x[rng.choice(N, k_nz, replace=False)] = rng.normal(0.0, 1.0, k_nz)
        y = A @ x + kw.pop("noise", 0.01) * rng.normal(0.0, 1.0, M)
        return WorkloadInstance(A=A, y=y, x_true=x)

    def prox_consensus(self, u: np.ndarray, K: int) -> np.ndarray:
        return soft_threshold_np(np.asarray(u), self.lam / (K * self.rho))

    def objective(self, A, y, x) -> float:
        xm = self._fold_for_eval(A, x)
        r = np.asarray(y) - np.asarray(A) @ xm
        return float(0.5 * np.dot(r, r) + self.lam * np.sum(np.abs(xm)))

    def reference_solution(self, A, y, K) -> np.ndarray:
        """The CENTRALIZED lasso optimum on the pooled data — what
        consensus ADMM converges to (contrast the column-split families,
        whose fixed point is per-block on ys)."""
        return ista_block(np.asarray(A, np.float64),
                          np.asarray(y, np.float64), l1=self.lam, l2=0.0)


@register
class ConsensusLogisticWorkload(ConsensusWorkload):
    name = "consensus_logistic"
    default_params = {"rho": 1.0, "lam": 0.1}
    # the decrypted local iterates feed each edge's next linearization
    # point, so rounding error recirculates through the local gradients
    # (same argument as the column-split logistic family)
    delta = 1e8

    def __init__(self, rho: float = 1.0, lam: float = 0.1, **params):
        super().__init__(rho=rho, lam=lam, **params)

    def make_instance(self, M: int, N: int, K: int,
                      seed: int = 0, **kw) -> WorkloadInstance:
        M = self._pad_rows(M, K)
        rng = np.random.default_rng(seed)
        A = rng.normal(0.0, 1.0, (M, N)) / np.sqrt(N)
        x = rng.normal(0.0, 2.0, N)
        p = _sigmoid(A @ x)
        b = (rng.random(M) < p).astype(np.float64)
        return WorkloadInstance(A=A, y=b, x_true=x)

    # -- state: per-edge curvature bounds + local gradients ---------------
    def init_state(self, A, y, ys, K,
                   y_scale: str = "consistent") -> WorkloadState:
        st = super().init_state(A, y, ys, K, y_scale=y_scale)
        st.aux["H"] = []
        for k in range(K):
            Ak = st.A[self.row_sl(st, k)]
            # H_k >= local logistic Hessian A_k^T D A_k (D <= 1/4 I);
            # no cross-block term — consensus coupling is through z only
            st.aux["H"].append(0.25 * (Ak.T @ Ak))
        st.aux["g"] = [self._local_grad(st, k, st.x_prev[st.sl(k)])
                       for k in range(K)]
        return st

    def _local_grad(self, st: WorkloadState, k: int,
                    xk: np.ndarray) -> np.ndarray:
        rs = self.row_sl(st, k)
        Ak = st.A[rs]
        return Ak.T @ (_sigmoid(Ak @ xk) - st.y[rs])

    # -- protocol hooks ----------------------------------------------------
    def edge_setup(self, st, k):
        return st.aux["H"][k], self.rho, self.rho

    def share_vector(self, st, k, Bk) -> np.ndarray:
        return np.zeros(st.Nk)                     # u3 = 0 (prox-linear)

    def iter_inputs(self, st, k):
        sl = st.sl(k)
        u1 = (st.aux["H"][k] @ st.x_prev[sl] - st.aux["g"][k]) / self.rho \
            + st.z[sl]
        return u1, -st.v[sl]

    def global_update(self, st, x_new) -> None:
        super().global_update(st, x_new)           # consensus z/v + x_prev
        st.aux["g"] = [self._local_grad(st, k, st.x_prev[st.sl(k)])
                       for k in range(st.K)]       # fresh LOCAL gradients

    def prox_consensus(self, u: np.ndarray, K: int) -> np.ndarray:
        return np.asarray(u) / (1.0 + self.lam / (K * self.rho))

    # -- evaluation --------------------------------------------------------
    def objective(self, A, y, x) -> float:
        xm = self._fold_for_eval(A, x)
        s = np.asarray(A, np.float64) @ xm
        return float(np.sum(_softplus(s) - np.asarray(y) * s)
                     + 0.5 * self.lam * np.dot(xm, xm))

    def reference_solution(self, A, y, K, iters: int = 20000) -> np.ndarray:
        """Centralized full-batch GD on the pooled regularized loss."""
        A = np.asarray(A, np.float64)
        y = np.asarray(y, np.float64)
        L = 0.25 * float(np.linalg.norm(A, 2) ** 2) + self.lam
        step = 1.0 / L
        x = np.zeros(A.shape[1])
        for _ in range(iters):
            g = A.T @ (_sigmoid(A @ x) - y) + self.lam * x
            x_new = x - step * g
            if float(np.max(np.abs(x_new - x))) < 1e-12:
                return x_new
            x = x_new
        return x

    def metrics(self, inst: WorkloadInstance, x: np.ndarray) -> dict:
        out = super().metrics(inst, x)
        xm = self._fold_for_eval(inst.A, x)
        pred = _sigmoid(inst.A @ xm) >= 0.5
        out["train_accuracy"] = float(np.mean(pred == (inst.y >= 0.5)))
        g = inst.A.T @ (_sigmoid(inst.A @ xm) - inst.y) + self.lam * xm
        out["grad_norm"] = float(np.linalg.norm(g))
        return out
