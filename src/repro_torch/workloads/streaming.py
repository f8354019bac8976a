"""Streaming LASSO — time-varying observations through the re-share hook.

The protocol's data-security-sharing phase encrypts ``u3_k = B_k A_k^T
ys`` ONCE; that bakes in the assumption that the observation vector is
static for the whole run.  This family breaks it: the run ingests a
deterministic schedule of observation segments (a drifting y — e.g. a
sliding window over a sensor stream whose underlying signal moves), and
every ``period`` rounds the master re-runs the share phase for all K
edges with the new segment's ``u3_k`` — the
:meth:`~repro_torch.workloads.base.Workload.reshare` streaming contract.  The
design matrix A (and hence every ``C_k``) stays fixed, so re-shares are
pure u3 refreshes: fresh Gamma_1 quantize -> encrypt -> ship, riding the
same coalescing + CipherTensor pipeline as the round's (u1, u2)
encryptions (zero extra kernel launches, zero mid-phase conversions —
pinned in tests/test_torch_workloads.py).

The schedule is a deterministic function of the instance (fixed
internal seed), so ``simulate_float``, every cipher arm, and the
runtime path all replay the identical stream — trajectories stay
bit-identical across arms.  Once the stream is exhausted the iteration
keeps running on the final segment; ``reference_solution`` is therefore
the blockwise LASSO fixed point of the LAST segment, which the
convergence test checks the iteration tracks.

Copied from ``repro.workloads.streaming`` (numpy only).
"""
from __future__ import annotations

import numpy as np

from . import register
from .base import WorkloadState, ista_block
from .lasso import LassoWorkload

_STREAM_SEED = 0x5EED


@register
class StreamingLassoWorkload(LassoWorkload):
    name = "streaming_lasso"
    streaming = True
    default_params = {"rho": 1.0, "lam": 0.05, "segments": 3, "period": 2}

    def __init__(self, rho: float = 1.0, lam: float = 0.05,
                 segments: int = 3, period: int = 2, drift: float = 0.25,
                 **params):
        super().__init__(rho=rho, lam=lam, **params)
        if segments < 1 or period < 1:
            raise ValueError("segments and period must be >= 1")
        self.segments = int(segments)
        self.period = int(period)
        self.drift = float(drift)

    # -- the deterministic observation stream ------------------------------
    def stream_schedule(self, A: np.ndarray, y: np.ndarray) -> np.ndarray:
        """(segments, M) observation schedule; row 0 is the given y.

        Each later segment drifts toward a fresh latent signal drawn from
        a FIXED internal rng: ``y_s = y_{s-1} + drift * (A x_s - y_{s-1})``
        — new data arriving about a moving ground truth.  Depending only
        on (A, y, params), every caller (float baseline, all cipher arms,
        the runtime, reference_solution) rebuilds the identical stream."""
        A = np.asarray(A, np.float64)
        y = np.asarray(y, np.float64)
        rng = np.random.default_rng(_STREAM_SEED)
        Y = np.empty((self.segments, y.size))
        Y[0] = y
        for s in range(1, self.segments):
            x_s = rng.normal(0.0, 1.0, A.shape[1])
            x_s *= (rng.random(A.shape[1]) < 0.2)      # sparse drift target
            Y[s] = Y[s - 1] + self.drift * (A @ x_s - Y[s - 1])
        return Y

    def _segment_of(self, t: int) -> int:
        return min(t // self.period, self.segments - 1)

    # -- state / streaming hooks -------------------------------------------
    def init_state(self, A, y, ys, K,
                   y_scale: str = "consistent") -> WorkloadState:
        st = super().init_state(A, y, ys, K, y_scale=y_scale)
        st.aux["stream"] = self.stream_schedule(st.A, st.y)
        st.aux["segment"] = 0
        return st

    def reshare(self, st: WorkloadState, t: int):
        seg = self._segment_of(t)
        if seg == st.aux["segment"]:
            return ()
        st.aux["segment"] = seg
        st.y = st.aux["stream"][seg]
        # re-shared segments keep the driver's y-scale convention
        st.ys = st.y / st.K if st.y_scale == "consistent" else st.y
        return range(st.K)           # shared y: every edge's u3_k changed

    # -- evaluation ---------------------------------------------------------
    def reference_solution(self, A, y, K) -> np.ndarray:
        """Blockwise LASSO fixed point of the FINAL segment — what the
        iteration tracks once the stream is exhausted."""
        A = np.asarray(A, np.float64)
        ys = self.stream_schedule(A, y)[-1] / K
        Nk = A.shape[1] // K
        x = np.zeros(A.shape[1])
        for k in range(K):
            sl = slice(k * Nk, (k + 1) * Nk)
            x[sl] = ista_block(A[:, sl], ys, l1=self.lam, l2=0.0)
        return x

    def metrics(self, inst, x) -> dict:
        # score against the final segment — the data the run ended on.
        # No mse_vs_truth: the stream drifts AWAY from the instance's
        # original latent x, so distance to it would misread tracking
        # quality; the final-segment objective is the tracking metric.
        y_last = self.stream_schedule(inst.A, inst.y)[-1]
        return {"objective": self.objective(inst.A, y_last, x)}
