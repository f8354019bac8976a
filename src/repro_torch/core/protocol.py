"""3P-ADMM-PC2 — the paper's three-phase master/edge privacy protocol.

Port of the synchronous driver of ``repro.core.protocol`` (Algorithm 1):

  * Initialization phase   — master splits A by columns, ships
    alpha_k = {A_k^T A_k, rho}; edge k returns B_k = (A_k^T A_k + rho I)^{-1}
    and keeps the quantized Gamma_2(B_k rho).
  * Data-security-sharing  — master quantizes+encrypts B_k A_k^T y (eq. 11);
    edge k stores the ciphertext alpha-hat.
  * Parallel privacy-computing — per iteration the master encrypts
    Gamma_2(u1_k), Gamma_2(u2_k); edge k evaluates eq. (13) entirely in
    ciphertext (one ⊕, one ⊗-matvec, one ⊕); master decrypts, dequantizes
    by Theorem 1 and runs the workload's plaintext global update.

The loop is workload-generic (``repro_torch.workloads``: every family of
the reference, row-split consensus families summing through secure
aggregation, streaming families re-sharing u3 mid-run), runs churn
schedules (graceful leave / rejoin with a full init-phase re-run), the
recycled-update cache, the live health watchers and the paper's
collaborative mode (Algorithm 3: the edge computes the masked p^2 half of
encryption and the p^2 reduction of decryption).

Cipher backends: ``plain`` (the exact integer chain, no encryption),
``gold`` (Python-int Paillier whose batches of >= 8 elements run on the
limb kernels through ``core.paillier_batch``, ciphertexts resident on the
device) and ``vec`` (the limb pipeline of ``core.paillier_vec``: int64
plaintexts, the ⊗-matvec at n^2 width).  The big-integer work runs on
``device`` (default the card); plaintext float64 math stays on the host,
as in the reference.

``deadline`` mode and ``cipher="auto"`` (per-op adaptive dispatch) run
on the event-driven runtime: :func:`run_protocol` hands them to
``repro_torch.runtime.runner.run_on_runtime``, as the reference does.
Every completed run appends one record to the run-history ledger
(``obs/ledger.record_run``; ``REPRO_LEDGER=off`` disables it).
"""
from __future__ import annotations

import dataclasses
import random
import time
from collections import defaultdict
from typing import Callable

import numpy as np
import torch

from .. import resolve_device
from .. import workloads as workloads_mod
from ..obs import health as health_mod
from ..obs import ledger as ledger_mod
from ..obs import metrics as obs_metrics
from ..obs import trace
from . import bigint as bi
from . import cipher_tensor as ct_mod
from . import paillier as gold
from . import paillier_batch as pb
from . import paillier_vec as pv
from .cipher_tensor import CipherTensor
from .quantization import (QuantSpec, gamma1, gamma2, gamma1_saturation,
                           gamma2_saturation, dequantize_theorem1)


# ---------------------------------------------------------------------------
# Cipher backends
# ---------------------------------------------------------------------------

class PlainBox:
    """Exact plaintext-integer simulation of the homomorphic ring ops;
    bumps the same logical op counters as the encrypted box."""

    name = "plain"

    def __init__(self, spec: QuantSpec, n_dim: int, counter=None):
        if not spec.int64_safe(n_dim):
            self._dtype = object     # python-int fallback for huge Delta
        else:
            self._dtype = np.int64
        self.counter = counter or OpCounter()

    def encrypt(self, m: np.ndarray) -> np.ndarray:
        m = np.asarray(m)
        self.counter.bump("enc", m.size)
        return m.astype(self._dtype)

    def add(self, c1, c2):
        self.counter.bump("mulmod", np.asarray(c1).size)
        return c1 + c2

    def matvec(self, K: np.ndarray, c):
        M, N = K.shape
        self.counter.bump("modexp", M * N)
        self.counter.bump("mulmod", M * (N - 1))
        return K.astype(self._dtype) @ c

    def decrypt(self, c) -> np.ndarray:
        self.counter.bump("dec", np.asarray(c).size)
        return np.asarray(c)

    def ct_bytes(self, n_el: int) -> int:
        return 8 * n_el  # plaintext int64 wire size


class GoldBox:
    """Python-int Paillier with the batched CRT fast path on ``device``.

    Batches of ``batch_min`` (default 8) or more elements run through
    ``core.paillier_batch``: the ModExps of a whole enc/dec/matvec call are
    kernel launches and the ciphertexts stay resident in limb form
    (:class:`CipherTensor`) between ops.  ``batch=False`` (or ``crt=False``)
    keeps the scalar loops, the bit-exactness reference.  Ciphertext values
    are identical either way (same rng stream).
    """

    name = "gold"

    def __init__(self, key: gold.PaillierKey, rng: random.Random,
                 crt: bool = True, counter=None, batch: bool = True,
                 batch_min: int | None = None, device=None):
        self.key = key
        self.rng = rng
        self.crt = crt
        self.counter = counter or OpCounter()
        self.batch = batch
        self.batch_min = pb.BATCH_MIN if batch_min is None else batch_min
        self.device = resolve_device(device)
        self._bk: pb.BatchKey | None = None

    def batch_key(self) -> pb.BatchKey:
        if self._bk is None:
            self._bk = pb.make_batch_key(self.key, self.device)
        return self._bk

    def encrypt(self, m: np.ndarray):
        flat = np.asarray(m).reshape(-1)
        self.counter.bump("enc", flat.size)
        # batched enc has encrypt_crt's semantics (m wraps mod n), so it
        # only stands in for the crt=True scalar loop
        if self.batch and self.crt and flat.size >= self.batch_min \
                and self.key.g == self.key.n + 1:
            return pb.enc_ct(self.batch_key(), flat, self.rng)
        enc = gold.encrypt_crt if self.crt else gold.encrypt
        return [enc(self.key, int(x), gold.rand_r(self.key, self.rng))
                for x in flat]

    def add(self, c1, c2):
        self.counter.bump("mulmod", len(c1))
        if self.batch and self.crt and isinstance(c1, CipherTensor) \
                and isinstance(c2, CipherTensor):
            return pb.add_ct(self.batch_key(), c1, c2)
        return [(a * b) % self.key.n2 for a, b in zip(c1, c2)]

    def matvec(self, K: np.ndarray, c):
        K = pb.exact_array(K)
        M, N = K.shape
        self.counter.bump("modexp", M * N)
        self.counter.bump("mulmod", M * (N - 1))
        if self.batch and self.crt and M * N >= self.batch_min:
            return pb.matvec_vec(self.batch_key(), K, c)
        out = []
        for i in range(M):
            acc = 1
            for j in range(N):
                acc = (acc * pow(c[j], int(K[i, j]), self.key.n2)) % self.key.n2
            out.append(acc)
        return out

    def decrypt(self, c) -> np.ndarray:
        self.counter.bump("dec", len(c))
        if self.batch and self.crt and len(c) >= self.batch_min:
            vals = pb.dec_vec(self.batch_key(), c)
        else:
            dec = gold.decrypt_crt if self.crt else gold.decrypt
            vals = [dec(self.key, x) for x in c]
        return np.array(vals, dtype=object)

    def ct_bytes(self, n_el: int) -> int:
        return (self.key.n2.bit_length() + 7) // 8 * n_el


class VecBox:
    """Batched limb-kernel Paillier (the accelerated ``vec`` arm).

    Ciphertexts are raw ``(B, L16(n^2))`` limb tensors on ``device``;
    the ⊗-matvec runs its ModExps at n^2 width with 64-bit exponents.
    ``plain_bits`` bounds the plaintexts this box decrypts (the Theorem-1
    chain width, ``QuantSpec.plaintext_bits``): up to 62 bits decryption
    narrows to int64 on the device, wider plaintexts decode losslessly
    through ``bigint.to_ints``.  ``None`` takes the key width.  The box
    shares the gold box's batch key for the same key and device.
    """

    name = "vec"

    def __init__(self, key: gold.PaillierKey, rng: random.Random,
                 counter=None, plain_bits: int | None = None, device=None):
        self.device = resolve_device(device)
        self._bk = pb.make_batch_key(key, self.device)
        self.vk = self._bk.vk
        self.key = key
        self.rng = rng
        self.counter = counter or OpCounter()
        self.plain_bits = key.n.bit_length() if plain_bits is None \
            else plain_bits

    def encrypt(self, m: np.ndarray):
        m = np.asarray(m).reshape(-1)
        if len(m) >= pb.BATCH_MIN:
            # r^n blinding pool through the CRT limb kernels, one launch
            rs = pb.rand_r_vec(self.key, len(m), self.rng)
            rn = pb.rn_pool_limbs(self._bk, rs)
        else:
            pool = gold.make_r_pool(self.key, len(m), self.rng)
            rn = torch.as_tensor(bi.from_ints(pool, self.vk.pack_n2.L16),
                                 device=self.device)
        self.counter.bump("enc", len(m))
        return pv.encrypt_batch(
            self.vk, torch.as_tensor(m.astype(np.int64), device=self.device),
            rn)

    def add(self, c1, c2):
        self.counter.bump("mulmod", int(c1.shape[0]))
        return pv.c_add_batch(self.vk, c1, c2)

    def matvec(self, K: np.ndarray, c):
        M, N = K.shape
        self.counter.bump("modexp", M * N)
        self.counter.bump("mulmod", M * (N - 1))
        return pv.c_matvec(
            self.vk, torch.as_tensor(np.asarray(K, np.int64),
                                     device=self.device), c)

    def decrypt(self, c) -> np.ndarray:
        """Limb-in decryption (a raw limb tensor or a
        :class:`CipherTensor`), int64 while ``plain_bits <= 62``, else
        lossless Python ints."""
        if isinstance(c, CipherTensor):
            c = c.limbs
        self.counter.bump("dec", int(c.shape[0]))
        m_limbs = pv.decrypt_batch_limbs(self.vk, c)
        if self.plain_bits <= 62:           # every plaintext fits int64
            m64 = pv.limbs_to_int64(m_limbs)
            if m64.device.type != "cuda":
                return m64.numpy()
            with trace.wait("wait.vec_decrypt"):
                return m64.cpu().numpy()
        return np.array(bi.to_ints(m_limbs), dtype=object)

    def ct_bytes(self, n_el: int) -> int:
        return (self.key.n2.bit_length() + 7) // 8 * n_el


# canonical protocol phase names — the OpCounter/RunReport vocabulary
PHASE_INIT = "init"
PHASE_SHARE = "share"
PHASE_ITERATE = "iterate"
PHASES = (PHASE_INIT, PHASE_SHARE, PHASE_ITERATE)
#: ops bumped before any driver set a phase land here
PHASE_UNSET = "unphased"


class OpCounter:
    """Per-phase crypto-op accounting with a byte-stable ``as_dict``."""

    def __init__(self):
        self.counts: dict[str, dict[str, int]] = defaultdict(lambda: defaultdict(int))
        self.phase: str | None = None

    def bump(self, op: str, n: int = 1):
        self.counts[self.phase if self.phase is not None
                    else PHASE_UNSET][op] += n

    def as_dict(self):
        order = [ph for ph in PHASES if ph in self.counts]
        order += sorted(ph for ph in self.counts if ph not in PHASES)
        return {ph: dict(sorted(self.counts[ph].items())) for ph in order}


# ---------------------------------------------------------------------------
# Protocol configuration / result
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ProtocolConfig:
    K: int = 3
    rho: float = 1.0
    lam: float = 1.0
    iters: int = 50
    spec: QuantSpec = QuantSpec()
    workload: str = "lasso"            # repro_torch.workloads registry name
    cipher: str = "plain"              # plain | gold | vec | auto
    key_bits: int = 256
    crt: bool = True
    collaborative: bool = False        # Algorithm 3 master/edge CRT split
    gold_batch: bool = True            # gold cipher: batched CRT fast path
    y_scale: str = "consistent"
    seed: int = 0
    # straggler knobs, handled by the runtime's deadline mode: latency_fn,
    # when given, replaces the CostModel compute charge with an explicit
    # per-(edge, iter) response time (link hops and ticks add on top)
    deadline: float | None = None      # straggler cutoff (simulated seconds)
    latency_fn: Callable[[int, int], float] | None = None
    # core.churn.ChurnSchedule of leave/rejoin/fail events (fail events
    # need the runtime's deadline machinery); recycle:
    # an edge whose quantized (u1, u2) moved by at most recycle_tol
    # integer steps since its last encrypted round reuses that round's
    # decrypted chain (Zhang 1910.04581)
    churn: object | None = None
    recycle: bool = False              # recycled-update mode
    recycle_tol: int = 0               # quantized-int reuse tolerance
    device: str = "cuda"               # where the big-integer work runs


@dataclasses.dataclass
class ProtocolResult:
    x: np.ndarray
    history: np.ndarray
    stats: dict
    stale_events: int


# ---------------------------------------------------------------------------
# Edge node — owns only what Remark 4 allows it to see
# ---------------------------------------------------------------------------

class EdgeNode:
    def __init__(self, k: int, spec: QuantSpec):
        self.k = k
        self.spec = spec
        self.Gb = None          # Gamma_2(B_k rho) integer matrix
        self.alpha_hat = None   # ciphertext of Gamma_1(B_k A_k^T y)
        # Algorithm-3 collaborative material (p^2 space only), and where
        # the edge's batched halves run (it needs no key material there)
        self.p2 = None
        self.phi_p2 = None
        self.g_p = None
        self.collab_batch = False
        self.collab_device = None

    def init_phase(self, Qk: np.ndarray, mu: float,
                   scale: float | None = None) -> np.ndarray:
        """B_k = (Q_k + mu I)^{-1}; keeps Gamma_2(scale * B_k)."""
        Nk = Qk.shape[0]
        scale = mu if scale is None else scale
        Bk = np.linalg.inv(Qk + mu * np.eye(Nk))
        self.Gb = np.asarray(gamma2(Bk * scale, self.spec))
        return Bk

    def store_shared(self, alpha_hat):
        self.alpha_hat = alpha_hat

    def private_step(self, z_hat, v_hat, box) -> object:
        s = box.add(z_hat, v_hat)            # z-hat ⊕ (-v-hat)
        t = box.matvec(self.Gb, s)           # Gamma_2(B-bar) ⊗ ...
        return box.add(self.alpha_hat, t)    # alpha-hat ⊕ ...

    # -- Algorithm 3: collaborative masked p^2-space ModExp ---------------
    def collab_setup(self, p2: int, phi_p2: int, g: int,
                     batch: bool = False, device=None):
        self.p2, self.phi_p2, self.g_p = p2, phi_p2, g % p2
        self.collab_batch = batch
        self.collab_device = device

    def collab_encrypt_half(self, masked_exp: np.ndarray) -> list[int]:
        """g'^{O(Gamma(z)) mod phi(p^2)} mod p^2 for each masked exponent:
        one ModExp launch mod p^2 under batched routing, else the scalar
        ``pow`` loop (bit-identical)."""
        es = [int(e) % self.phi_p2
              for e in np.asarray(masked_exp).reshape(-1)]
        if self.collab_batch and len(es) >= pb.BATCH_MIN:
            return ct_mod.modexp_mod_vec(self.g_p, es, self.p2,
                                         device=self.collab_device)
        return self._collab_half_scalar(es)

    def _collab_half_scalar(self, es: list[int]) -> list[int]:
        return [pow(self.g_p, e, self.p2) for e in es]

    def reduce_p2(self, x_hat) -> list[int]:
        """(x-hat)' = x-hat mod p^2 (decryption assist, round 1).

        A limb-resident batch reduces straight off its limbs on their
        device; int lists batch-reduce too under batched routing, else
        take the per-element host ``%`` loop."""
        if isinstance(x_hat, CipherTensor):
            return ct_mod.reduce_mod_vec(x_hat, self.p2)
        if self.collab_batch and len(x_hat) >= pb.BATCH_MIN:
            return ct_mod.reduce_mod_vec(x_hat, self.p2,
                                         device=self.collab_device)
        return self._reduce_p2_scalar(x_hat)

    def _reduce_p2_scalar(self, x_hat) -> list[int]:
        return [int(c) % self.p2 for c in x_hat]


# ---------------------------------------------------------------------------
# Protocol driver (master node logic)
# ---------------------------------------------------------------------------

def check_plaintext_fits(key: gold.PaillierKey, spec: QuantSpec,
                         n_dim: int) -> None:
    """Raise unless the Theorem-1 integer chain stays below n (Remark 2)."""
    need = spec.plaintext_bits(n_dim)
    if need >= key.n.bit_length():
        raise ValueError(
            f"plaintext chain needs {need} bits but n has "
            f"{key.n.bit_length()}; raise key_bits or lower Delta")


def make_box(cfg: ProtocolConfig, n_dim: int, rng: random.Random,
             counter: "OpCounter", device=None):
    """Key material + cipher box for ``cfg.cipher``; returns ``(box, key)``.

    ``auto`` is the runtime's: it builds its AdaptiveBox itself (this
    module imports the runtime only inside :func:`run_protocol`)."""
    if cfg.cipher == "plain":
        return PlainBox(cfg.spec, n_dim, counter=counter), None
    if cfg.cipher not in ("gold", "vec"):
        raise ValueError(cfg.cipher)
    # g = n+1 also serves Algorithm 3: the masked p^2-space offload uses
    # the raw g and is correct either way
    key = gold.keygen(cfg.key_bits, rng, g=None)
    check_plaintext_fits(key, cfg.spec, n_dim)
    if cfg.cipher == "gold":
        return GoldBox(key, rng, crt=cfg.crt, counter=counter,
                       batch=cfg.gold_batch, device=device), key
    return VecBox(key, rng, counter=counter,
                  plain_bits=cfg.spec.plaintext_bits(n_dim),
                  device=device), key


def resolve_workload(cfg: ProtocolConfig,
                     workload: "workloads_mod.Workload | None" = None
                     ) -> "workloads_mod.Workload":
    """An explicit instance wins, else the registry entry ``cfg.workload``."""
    if workload is not None:
        return workload
    return workloads_mod.get(cfg.workload, rho=cfg.rho, lam=cfg.lam)


def run_protocol(A: np.ndarray, y: np.ndarray, cfg: ProtocolConfig,
                 workload: "workloads_mod.Workload | None" = None,
                 health=False, device=None) -> ProtocolResult:
    """Run 3P-ADMM-PC2 end to end; master-node state lives in this frame.

    ``device`` (default ``cfg.device``, the card) is where the cipher
    boxes, secure aggregation and the collaborative edges run their
    big-integer work; ``"cuda"`` without a card raises.  The encrypted
    chain per edge per round is enc(Γ₂ u1) ⊕ enc(Γ₂ u2), ⊗ by the edge's
    Γ₂(C_k), ⊕ the stored Γ₁(u3_k).  ``health`` turns on the live
    watchers (``stats["health"]``, outside the report core).
    ``stats["seconds"]`` (outside the core too) holds the wall seconds
    per phase and per round, ``stats["waits"]`` the times the process
    blocked on the card while the run was open, by site, and
    ``stats["exps"]`` the batched ModExp's per-element exponents by the
    path the host took, where it took any (``obs.metrics.PROCESS``).
    ``deadline`` mode and ``cipher="auto"`` run on the event-driven
    runtime (``runtime.runner.run_on_runtime``).
    """
    if cfg.deadline is not None or cfg.cipher == "auto":
        # straggler/deadline semantics and adaptive dispatch live in the
        # event-driven runtime; the loop below is the synchronous driver
        from ..runtime.runner import run_on_runtime
        return run_on_runtime(A, y, cfg, workload=workload, health=health,
                              device=device)
    dev = resolve_device(cfg.device if device is None else device)
    monitor = health_mod.as_monitor(health)
    wl = resolve_workload(cfg, workload)
    rng = random.Random(cfg.seed)
    K = cfg.K
    churn = cfg.churn
    if churn is not None:
        churn.check(K, cfg.iters)
        if churn.has_fails:
            raise ValueError(
                "fail events (silent crashes) need the runtime driver's "
                "deadline machinery; the synchronous reference loop only "
                "models graceful leave/rejoin")
    N_state, Nk = wl.dims(A, K)
    spec = cfg.spec
    clock = _PhaseClock(dev)
    waits0 = dict(obs_metrics.PROCESS.counters)

    counter = OpCounter()
    traffic = defaultdict(int)

    # --- Initialization phase -------------------------------------------
    with trace.span("driver.init"):
        box, key = make_box(cfg, Nk, rng, counter, device=dev)
        counter.phase = PHASE_INIT
        ys = y / K if cfg.y_scale == "consistent" else y
        st = wl.init_state(np.asarray(A, np.float64),
                           np.asarray(y, np.float64), ys, K,
                           y_scale=cfg.y_scale)
        agg_ctx = None
        if wl.uses_secure_agg:
            # row-split consensus: the z-update's cross-edge aggregate
            # runs through secure aggregation (encrypted when the run has a
            # key, the bit-exact plaintext mirror otherwise) on its own rng
            # stream
            agg_ctx = workloads_mod.SecureAggContext.for_run(
                spec, key, cfg.seed, counter, box.ct_bytes(1), device=dev)
            st.aux["secure_agg"] = agg_ctx
        edges = [EdgeNode(k, spec) for k in range(K)]
        C_rowsums, Bks, u3s = [], [], []
        for k, edge in enumerate(edges):
            Qk, mu, scale = wl.edge_setup(st, k)
            traffic["master->edge"] += Qk.nbytes
            Bk = edge.init_phase(Qk, mu, scale)
            traffic["edge->master"] += Bk.nbytes
            C_rowsums.append((Bk * scale) @ np.ones(Nk))
            Bks.append(Bk)
            u3s.append(wl.share_vector(st, k, Bk))
            if cfg.collaborative and key is not None:
                edge.collab_setup(key.p2, key.phi_p2, key.g,
                                  batch=cfg.gold_batch, device=dev)
        clock.lap(PHASE_INIT)

    # --- Data security sharing phase -------------------------------------
    with trace.span("driver.share"):
        counter.phase = PHASE_SHARE
        for k, edge in enumerate(edges):
            q_alpha = np.asarray(gamma1(u3s[k], spec))
            if monitor.enabled:
                monitor.observe_quant(-1, *gamma1_saturation(q_alpha, spec))
            c_alpha = box.encrypt(q_alpha)
            traffic["master->edge"] += box.ct_bytes(Nk)
            edge.store_shared(c_alpha)
        clock.lap(PHASE_SHARE)

    # --- Parallel privacy-computing phase ---------------------------------
    counter.phase = PHASE_ITERATE
    history = np.zeros((cfg.iters, N_state))
    reshare_events = 0
    active = set(range(K))
    churn_counts = {"leaves": 0, "rejoins": 0}
    if churn is not None:
        st.aux["churn_active"] = np.ones(K, dtype=bool)
    # recycled-update cache: the quantized (u1, u2) pair of each edge's
    # last encrypted round and the decrypted chain it produced,
    # invalidated whenever the edge's stored u3 changes
    last_q: list = [None] * K
    last_R: list = [None] * K
    recycled = 0

    for t in range(cfg.iters):
        with trace.span("driver.round", f"round={t}"):
            if churn is not None:
                # membership events at the top of the round, before the
                # re-shares, in schedule order (this fixes the rng stream)
                for ev in churn.events_at(t):
                    k = ev.edge
                    last_q[k] = last_R[k] = None
                    if ev.kind == "leave":
                        # graceful handoff: the block freezes (column
                        # split) or folds out of the consensus aggregate
                        # (row split)
                        active.discard(k)
                        st.aux["churn_active"][k] = False
                        churn_counts["leaves"] += 1
                        continue
                    # rejoin: full init-phase re-run and a fresh Γ₁(u3_k)
                    active.add(k)
                    st.aux["churn_active"][k] = True
                    churn_counts["rejoins"] += 1
                    Qk, mu, scale = wl.edge_setup(st, k)
                    traffic["master->edge"] += Qk.nbytes
                    Bk = edges[k].init_phase(Qk, mu, scale)
                    traffic["edge->master"] += Bk.nbytes
                    C_rowsums[k] = (Bk * scale) @ np.ones(Nk)
                    Bks[k] = Bk
                    u3s[k] = wl.share_vector(st, k, Bk)
                    c_alpha = box.encrypt(np.asarray(gamma1(u3s[k], spec)))
                    traffic["master->edge"] += box.ct_bytes(Nk)
                    edges[k].store_shared(c_alpha)
            if wl.streaming:
                # re-run the encrypted share phase for the edges whose u3
                # moved; absent edges miss the refresh (a rejoin re-runs all)
                for k in wl.reshare(st, t):
                    if k not in active:
                        continue
                    u3s[k] = wl.share_vector(st, k, Bks[k])
                    c_alpha = box.encrypt(np.asarray(gamma1(u3s[k], spec)))
                    traffic["master->edge"] += box.ct_bytes(Nk)
                    edges[k].store_shared(c_alpha)
                    reshare_events += 1
                    last_q[k] = last_R[k] = None
            x_new = np.zeros(N_state)
            for k, edge in enumerate(edges):
                sl = slice(k * Nk, (k + 1) * Nk)
                if k not in active:
                    x_new[sl] = st.x_prev[sl]      # frozen handoff block
                    continue
                with trace.span("driver.edge", f"round={t},edge={k}"):
                    u1, u2 = wl.iter_inputs(st, k)
                    qz = np.asarray(gamma2(u1, spec))
                    qv = np.asarray(gamma2(u2, spec))
                    if monitor.enabled:
                        cz_n, tz_n = gamma2_saturation(qz, spec)
                        cv_n, tv_n = gamma2_saturation(qv, spec)
                        monitor.observe_quant(t, cz_n + cv_n, tz_n + tv_n)
                    w_sum = float(np.sum(u1 + u2))
                    if cfg.recycle and last_q[k] is not None \
                            and int(np.max(np.abs(qz - last_q[k][0]))) \
                            <= cfg.recycle_tol \
                            and int(np.max(np.abs(qv - last_q[k][1]))) \
                            <= cfg.recycle_tol:
                        # recycled update (Zhang 1910.04581): the
                        # quantized inputs match the edge's last encrypted
                        # round, so its chain would decrypt to the cached R
                        # — skip enc/step/dec
                        counter.bump("recycled", Nk)
                        recycled += 1
                        R = last_R[k]
                    else:
                        cz = box.encrypt(qz)
                        cv = box.encrypt(qv)
                        traffic["master->edge"] += 2 * box.ct_bytes(Nk)
                        x_hat = edge.private_step(cz, cv, box)
                        traffic["edge->master"] += box.ct_bytes(Nk)
                        if cfg.collaborative and key is not None \
                                and cfg.cipher == "gold":
                            # decryption assist: the edge ships (x-hat)'
                            # mod p^2; the reference discards it too, but
                            # its ops and bytes are part of the report
                            _ = edge.reduce_p2(x_hat)
                            traffic["edge->master"] += \
                                (key.p2.bit_length() + 7) // 8 * Nk
                        R = box.decrypt(x_hat).astype(np.float64)
                        if cfg.recycle:
                            last_q[k] = (qz, qv)
                            last_R[k] = R
                    x_new[sl] = np.asarray(dequantize_theorem1(
                        R, C_rowsums[k], w_sum, Nk, spec))
            with trace.span("driver.master", f"round={t}"):
                if monitor.enabled:
                    # iterate step vs the (t-1) iterate, before the update
                    monitor.observe_round(
                        t, float(np.mean((x_new - st.x_prev) ** 2)))
                # master updates (10b)/(10c) with the (t-1) iterate —
                # Jacobi order
                wl.global_update(st, x_new)
                history[t] = x_new
            clock.lap(PHASE_ITERATE)

    with trace.span("driver.report"):
        if agg_ctx is not None:
            traffic["edge->master"] += agg_ctx.traffic_bytes
        stats = obs_metrics.build_run_report(
            driver="protocol", ops=counter.as_dict(), traffic=traffic,
            key_bits=None if key is None else key.n.bit_length(),
            cipher=cfg.cipher, workload=wl.name,
            reshare_events=reshare_events, history=history,
            churn={**churn_counts, "recycled": recycled})
        if monitor.enabled:
            stats["health"] = monitor.health_section()
        # run-history ledger: one compact record per completed run (no-op
        # when REPRO_LEDGER is off; never raises)
        ledger_mod.record_run(stats, cfg=cfg, mode="sync", device=dev)
    stats["seconds"] = clock.seconds
    stats["waits"] = obs_metrics.PROCESS.since(waits0, "wait.")
    stats["exps"] = obs_metrics.PROCESS.since(waits0, "exps.")
    return ProtocolResult(x=st.x_prev, history=history, stats=stats,
                          stale_events=0)


class _PhaseClock:
    """Wall seconds per protocol phase, and per round of the iterate phase
    (device work is synchronized at each lap)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.seconds: dict = {"rounds": []}
        self._t = time.perf_counter()

    def lap(self, phase: str) -> None:
        if self.device.type == "cuda":
            with trace.wait("wait.lap"):
                torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        dt, self._t = now - self._t, now
        self.seconds[phase] = self.seconds.get(phase, 0.0) + dt
        if phase == PHASE_ITERATE:
            self.seconds["rounds"].append(dt)


# ---------------------------------------------------------------------------
# Algorithm-3 collaborative encryption (masked p^2-space offload)
# ---------------------------------------------------------------------------

def collaborative_encrypt(key: gold.PaillierKey, edge: EdgeNode,
                          m: np.ndarray, rng: random.Random) -> list[int]:
    """Master encrypts plaintexts with the p^2 ModExp offloaded to an edge.

    Obfuscation O(m) = m + t with t uniform 64-bit (additive mask); the
    edge returns g'^{O(m) mod phi(p^2)} mod p^2 and the master unmasks by
    multiplying g'^{-t mod phi(p^2)}.  The edge learns only p^2, phi(p^2)
    and a uniformly masked exponent (Remark 4).
    """
    m = np.asarray(m).reshape(-1)
    masks = [rng.getrandbits(64) for _ in m]
    masked = np.array([int(x) + t for x, t in zip(m, masks)], dtype=object)
    # --- edge side (p^2 space) ---
    e_half = edge.collab_encrypt_half(masked)
    # --- master side: unmask + q^2 space + CRT combine + blinding ---
    out = []
    for mi, ti, ep in zip(m, masks, e_half):
        un = pow(key.g, -ti % key.phi_p2, key.p2)
        gp = (ep * un) % key.p2                       # g^m mod p^2
        gq = pow(key.g, int(mi) % key.phi_q2, key.q2)  # g^m mod q^2
        gm = gold.crt_combine(key, gp, gq)
        rn = pow(gold.rand_r(key, rng), key.n, key.n2)
        out.append((gm * rn) % key.n2)
    return out


def collab_encrypt_vec(key: gold.PaillierKey, edge: EdgeNode,
                       m: np.ndarray, rng: random.Random,
                       device=None) -> list[int]:
    """Whole-batch :func:`collaborative_encrypt` on ``device`` (default
    the card): no Python ``pow`` loops.

    Same information flow, same rng stream, identical ciphertexts: every
    64-bit mask draws first, the edge answers its (batched, if routed)
    p^2 half, then the master's three ModExp batches — the unmask factors
    mod p^2 (exponents up to phi(p^2)'s width), the q^2 half, and the r^n
    blindings in the CRT half spaces — run as kernel launches.
    """
    dev = resolve_device(device)
    m = np.asarray(m).reshape(-1)
    masks = [rng.getrandbits(64) for _ in m]
    masked = np.array([int(x) + t for x, t in zip(m, masks)], dtype=object)
    # --- edge side (p^2 space) ---
    e_half = edge.collab_encrypt_half(masked)
    # --- master side, batched ---
    uns = ct_mod.modexp_mod_vec(key.g, [-t % key.phi_p2 for t in masks],
                                key.p2, device=dev)
    gqs = ct_mod.modexp_mod_vec(key.g, [int(x) % key.phi_q2 for x in m],
                                key.q2, device=dev)
    bk = pb.make_batch_key(key, dev)
    rs = pb.rand_r_vec(key, len(m), rng)
    rns = pb.modexp_crt_vec(bk, rs, key.n)
    out = []
    for ep, un, gq, rn in zip(e_half, uns, gqs, rns):
        gp = (ep * un) % key.p2                       # g^m mod p^2
        gm = gold.crt_combine(key, gp, gq)
        out.append(gm * rn % key.n2)
    return out
