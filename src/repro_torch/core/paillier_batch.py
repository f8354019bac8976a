"""Batched CRT fast path for the gold (Python-int) Paillier pipeline.

Port of ``repro.core.paillier_batch`` (its single-key part): a whole batch
of ModExps runs on the limb kernels (``kernels/ops.py``) in the paper's
two CRT half-width spaces Z_{p^2} x Z_{q^2} (eqs. 35-40), and the eq. (38)
recombination is done once per batch in limb space
(:func:`paillier_vec.crt_combine_batch`).  Ciphertexts stay resident on
the device as :class:`~repro_torch.core.cipher_tensor.CipherTensor`
batches between protocol ops; Python ints appear only where plaintexts
enter or leave.

Bit-exactness: every function returns exactly what the scalar gold
functions return for the same inputs and the same ``random.Random``
stream.  A :class:`BatchKey` names the device its tensors live on.  On a
box of several cards the CRT bodies split their batch over them
(:func:`_shard_batch`); on one card or the CPU they run whole.

Preconditions shared by all batched ModExps: bases must be units mod n
(ciphertexts and blinding factors are).  Negative exponents are handled
exactly as CPython's ``pow``: the base is inverted mod n^2 host-side and
the ladder runs on ``-e``.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import functools
import random
import time
from typing import Sequence

import numpy as np
import torch

from .. import resolve_device
from . import bigint as bi
from . import paillier as gold
from . import paillier_vec as pv
from .cipher_tensor import CipherTensor
from ..kernels import ops
from ..obs import metrics as obs_metrics
from ..obs import trace

# Below this batch size the per-launch overhead dominates and callers keep
# the scalar gold path (the protocol boxes apply this threshold).
BATCH_MIN = 8


@dataclasses.dataclass(frozen=True, eq=False)
class BatchKey:
    """Gold key + the limb-packed material the kernels need + the device."""
    key: gold.PaillierKey
    vk: pv.VecKey
    device: torch.device


@functools.lru_cache(maxsize=None)
def _batch_key(key: gold.PaillierKey, device: str) -> BatchKey:
    return BatchKey(key=key, vk=pv.make_vec_key(key),
                    device=torch.device(device))


def make_batch_key(key: gold.PaillierKey, device=None) -> BatchKey:
    """Limb-pack ``key`` for ``device`` (default cuda; cached per pair)."""
    return _batch_key(key, str(resolve_device(device)))


@trace.spanned("paillier.blind")
def rand_r_vec(key: gold.PaillierKey, count: int,
               rng: random.Random) -> list[int]:
    """``count`` blinding units r in Z*_n — same stream as repeated
    :func:`gold.rand_r`."""
    return [gold.rand_r(key, rng) for _ in range(count)]


def _limbs(bk: BatchKey, ints, L: int) -> torch.Tensor:
    """``ints`` as (len, L) limbs on ``bk.device``; a copy to a card from
    pageable memory waits for its stream to drain."""
    host = bi.from_ints(ints, L)
    if bk.device.type != "cuda":
        return torch.as_tensor(host, device=bk.device)
    with trace.wait("wait.limbs"):
        return torch.as_tensor(host, device=bk.device)


# ---------------------------------------------------------------------------
# Core primitive: batched base^e mod n^2 via the CRT half spaces
# ---------------------------------------------------------------------------

def _norm_exps(exps, batch: int) -> list[int]:
    if isinstance(exps, (int, np.integer)):
        exps = [int(exps)] * batch
    else:
        with trace.span("paillier.exps"):
            exps = [int(e) for e in exps]
    if len(exps) != batch:
        raise ValueError(f"{len(exps)} exponents for a batch of {batch}")
    return exps


def exact_array(x) -> np.ndarray:
    """``x`` as an array whose every integer is exact: an integer array as
    it is, anything else as objects (numpy infers floats for a list that
    mixes ints past 2^63 with negative ones)."""
    a = np.asarray(x)
    return a if a.dtype.kind in "iu" else np.asarray(x, dtype=object)


def _int64_exps(exps):
    """``(k64, lo, top)``: the exponents as a flat int64 array with their
    least and greatest entry, or ``None`` where one is wider than int64.
    Anything but a signed-integer array goes entry by entry (a list or an
    object array of Python ints, an unsigned array)."""
    flat = exact_array(exps).reshape(-1)
    if flat.dtype.kind != "i":
        flat = flat.astype(object, copy=False)
    try:
        k64 = flat.astype(np.int64)
    except OverflowError:
        return None
    if not k64.size:
        return k64, 0, 0
    return k64, int(k64.min()), int(k64.max())


class Shards(list):
    """Per-card argument tuples of a split batch: ``(card, chunks)``."""


def _shard_batch(*arrays, group: int = 1):
    """Lay ``(B, ...)`` operand tensors across the cards of
    :func:`repro_torch.launch.mesh.kernel_mesh`: card i gets the i-th
    equal chunk of every array's leading axis, in whole ``group``s of
    rows, copied to it.

    On one card or the CPU (``kernel_mesh`` is ``None``) the arrays come
    back untouched, as one array when one was given, as in the
    reference; so does a batch whose groups the card count does not
    divide.  Otherwise the result is a :class:`Shards`.  Every limb
    kernel is batch-elementwise, so each card's chunk runs the whole
    ladder with no traffic between cards until :func:`_run_split`
    gathers the results.
    """
    from ..launch import mesh as mesh_mod
    cards = mesh_mod.kernel_mesh(arrays[0].device)
    groups = int(arrays[0].shape[0]) // group
    if cards is None or groups == 0 or groups % len(cards):
        return arrays if len(arrays) != 1 else arrays[0]
    rows = groups // len(cards) * group
    return Shards(
        (card, tuple(x[i * rows:(i + 1) * rows].to(card, non_blocking=True)
                     for x in arrays))
        for i, card in enumerate(cards))


def _on_card(body, card: torch.device, chunks: tuple) -> torch.Tensor:
    with torch.cuda.device(card):
        return body(*chunks)


def _run_split(body, *arrays, group: int = 1) -> torch.Tensor:
    """``body(*arrays)``, each card running it on its chunk, the results
    concatenated on the first array's device; whole where
    :func:`_shard_batch` leaves the batch whole.  Cards run their chunks
    from a thread each, so their launches overlap (CPU devices, which
    only rehearse the split, take their chunks in turn)."""
    shards = _shard_batch(*arrays, group=group)
    if not isinstance(shards, Shards):
        return body(*arrays)
    if shards[0][0].type == "cuda":
        with concurrent.futures.ThreadPoolExecutor(len(shards)) as pool:
            outs = list(pool.map(lambda s: _on_card(body, *s), shards))
    else:
        outs = [body(*chunks) for _, chunks in shards]
    home = arrays[0].device
    return torch.cat([o.to(home) for o in outs])


def _crt_body(bk: BatchKey, scalar_e, fixed: bool, then=None):
    """The CRT body over (bp, bq) or (bp, ep, bq, eq) limb tensors:
    x' = bp^e mod p^2, x'' = bq^e mod q^2, recombined mod n^2, then
    ``then`` (the matvec's product tree) on the result."""
    key, vk = bk.key, bk.vk
    packs = (vk.pack_p2, vk.pack_q2)

    def body(*args):
        if fixed and scalar_e is not None:
            xp, xq = ops.modexp_fixed_pair(
                args, (scalar_e % key.phi_p2, scalar_e % key.phi_q2), packs)
        else:
            bp, ep, bq, eq = args
            xp = ops.modexp(bp, ep, vk.pack_p2)
            xq = ops.modexp(bq, eq, vk.pack_q2)
        x = pv.crt_combine_batch(vk, xp, xq)
        return x if then is None else then(x)
    return body


def _halves(bk: BatchKey, bp, bq, exps, scalar_e, fixed: bool,
            group: int = 1, then=None):
    """x' = bp^e mod p^2, x'' = bq^e mod q^2, recombined mod n^2 (and
    ``then`` applied), split over the cards in whole ``group``s of rows
    (:func:`_run_split`).  Exponent limbs size to the whole batch's
    maximum after the phi reduction.

    Per-element ``exps`` (a sequence or an array of ints) that fit int64
    and lie in [0, min(phi(p^2), phi(q^2))) are their own residues: they
    go up once and split into limbs on the device, one tensor for both
    halves.  Any other list is reduced and packed on the host.
    ``obs.metrics.PROCESS`` counts the exponents of each path
    (``exps.int64``, ``exps.reduced``)."""
    key = bk.key
    body = _crt_body(bk, scalar_e, fixed, then)
    if fixed and scalar_e is not None:
        return _run_split(body, bp, bq, group=group)
    with trace.span("paillier.exps"):
        fit = _int64_exps(exps)
    if fit is not None and 0 <= fit[1] and fit[2] < min(key.phi_p2,
                                                         key.phi_q2):
        k64, _, top = fit
        obs_metrics.PROCESS.count("exps.int64", k64.size)
        e = pv.int64_to_limbs(bi.to_device(k64, bk.device),
                              bi.n_limbs_for(top))
        return _run_split(body, bp, e, bq, e, group=group)
    obs_metrics.PROCESS.count("exps.reduced", len(exps))
    with trace.span("paillier.exps_phi"):
        ep = [int(e) % key.phi_p2 for e in exps]
        eq = [int(e) % key.phi_q2 for e in exps]
        le = max(1, max(bi.n_limbs_for(e) for e in ep + eq))
    return _run_split(body, bp, _limbs(bk, ep, le), bq, _limbs(bk, eq, le),
                      group=group)


def modexp_crt_limbs(bk: BatchKey, bases: Sequence[int], exps,
                     fixed: bool = False) -> torch.Tensor:
    """[b^e mod n^2] as (B, L16(n^2)) limbs; ``exps`` scalar or per-element.

    ``fixed=True`` runs a SCALAR exponent through the host-known
    fixed-window ladder (``ops.modexp_fixed_pair``); per-element exponent
    lists ignore the flag.  Exponent limbs size to the batch maximum
    after the phi reduction.
    """
    key, vk = bk.key, bk.vk
    B = len(bases)
    scalar_e = int(exps) if isinstance(exps, (int, np.integer)) else None
    exps = _norm_exps(exps, B)
    with trace.span("paillier.exps_sign"):
        bases = [int(b) for b in bases]
        for i, e in enumerate(exps):
            if e < 0:   # pow()-compatible: invert the base (egcd), negate e
                bases[i] = pow(bases[i], -1, key.n2)
                exps[i] = -e
    with trace.span("paillier.residues"):
        rp = [b % key.p2 for b in bases]
        rq = [b % key.q2 for b in bases]
    bp = _limbs(bk, rp, vk.pack_p2.L16)
    bq = _limbs(bk, rq, vk.pack_q2.L16)
    if scalar_e is not None:
        scalar_e = abs(scalar_e)
    return _halves(bk, bp, bq, exps, scalar_e, fixed)


def modexp_crt_limbs_in(bk: BatchKey, base_limbs: torch.Tensor, exps,
                        fixed: bool = False) -> torch.Tensor:
    """:func:`modexp_crt_limbs` for bases already resident in limb form
    (a :class:`CipherTensor`'s payload): the reduction into the two half
    spaces runs on the device (``paillier_vec._reduce_into``).  Exponents
    must be nonnegative."""
    vk = bk.vk
    B = int(base_limbs.shape[0])
    scalar_e = int(exps) if isinstance(exps, (int, np.integer)) else None
    exps = _norm_exps(exps, B)
    with trace.span("paillier.exps_sign"):
        negative = any(e < 0 for e in exps)
    if negative:
        raise ValueError("limb-resident ModExp needs nonnegative exponents")
    bp = pv._reduce_into(base_limbs, vk.pack_p2)
    bq = pv._reduce_into(base_limbs, vk.pack_q2)
    return _halves(bk, bp, bq, exps, scalar_e, fixed)


def modexp_crt_vec(bk: BatchKey, bases: Sequence[int], exps,
                   fixed: bool = False) -> list[int]:
    """Int-in/int-out batched ``pow(b, e, n^2)`` (see modexp_crt_limbs)."""
    if not len(bases):
        return []
    return bi.to_ints(modexp_crt_limbs(bk, bases, exps, fixed=fixed))


def pow_c_vec(bk: BatchKey, cs, ks, fixed: bool = False) -> list[int]:
    """Batched plaintext-constant multiply ⊗: [c^k mod n^2] elementwise."""
    if isinstance(cs, CipherTensor):
        return pow_c_ct(bk, cs, ks, fixed=fixed).to_ints()
    return modexp_crt_vec(bk, cs, ks, fixed=fixed)


def pow_c_ct(bk: BatchKey, cs: CipherTensor, ks,
             fixed: bool = False) -> CipherTensor:
    """Limb-in/limb-out ⊗ over a resident ciphertext batch."""
    exps = _norm_exps(ks, len(cs))
    with trace.span("paillier.exps_sign"):
        negative = any(e < 0 for e in exps)
    if negative:   # host base inversion: materialize once
        return CipherTensor(
            bk, modexp_crt_limbs(bk, cs.to_ints(), ks, fixed=fixed))
    return CipherTensor(bk, modexp_crt_limbs_in(bk, cs.limbs, ks,
                                                fixed=fixed))


# ---------------------------------------------------------------------------
# Encryption / decryption / homomorphic matvec
# ---------------------------------------------------------------------------

def _enc_ct_impl(bk: BatchKey, ms: list[int], rs: list[int]) -> CipherTensor:
    """g=n+1 encryption in limb space: c = (1 + m n) * r^n mod n^2, with
    r^n through the CRT half spaces; the ciphertexts are born resident."""
    key, vk = bk.key, bk.vk
    rn = modexp_crt_limbs(bk, rs, key.n, fixed=True)
    with trace.span("paillier.encode"):
        ms = [m % key.n for m in ms]
    m_limbs = _limbs(bk, ms, vk.pack_n.L16)
    gm = bi.mul(m_limbs, pv._row(vk.n_limbs, m_limbs),
                out_limbs=vk.pack_n2.L16)                   # m*n < n^2
    gm = bi.add(gm, pv._one(gm.shape[-1], gm))              # 1 + m n
    return CipherTensor(bk, ops.mulmod(gm, rn, vk.pack_n2))


def enc_ct(bk: BatchKey, ms, rng: random.Random) -> CipherTensor:
    """Batched g=n+1 encryption, limb-out: one launch for all blindings.

    Draws r exactly like the scalar loop (same rng stream); the result
    materializes to ints bit-identical to
    ``[gold.encrypt_crt(key, m, rand_r(key, rng)) for m in ms]``.
    """
    key = bk.key
    if key.g != key.n + 1:
        raise NotImplementedError("batched path uses the g = n+1 fast path")
    with trace.span("paillier.encode"):
        ms = [int(m) for m in np.asarray(ms, dtype=object).reshape(-1)]
    if not ms:
        return CipherTensor(bk, torch.zeros((0, bk.vk.pack_n2.L16),
                                            dtype=torch.int32,
                                            device=bk.device), ints=[])
    rs = rand_r_vec(key, len(ms), rng)
    return _enc_ct_impl(bk, ms, rs)


def enc_vec(bk: BatchKey, ms, rng: random.Random) -> list[int]:
    """Int-out form of :func:`enc_ct` (same rng stream, same ciphertexts)."""
    return enc_ct(bk, ms, rng).to_ints()


def add_ct(bk: BatchKey, c1: CipherTensor, c2: CipherTensor) -> CipherTensor:
    """⊕ on resident batches: one batched Barrett mulmod launch mod n^2."""
    return CipherTensor(bk, ops.mulmod(c1.limbs, c2.limbs, bk.vk.pack_n2))


def rn_pool_limbs(bk: BatchKey, rs: Sequence[int]) -> torch.Tensor:
    """Blinding pool r -> r^n mod n^2 as (B, L16(n^2)) limbs on
    ``bk.device`` (the ``vec`` arm's encryption blindings, one
    fixed-exponent launch over both CRT halves)."""
    return modexp_crt_limbs(bk, rs, bk.key.n, fixed=True)


def dec_vec(bk: BatchKey, cs) -> list[int]:
    """Batched decryption: c^lam for the whole batch in one CRT launch.

    L(x) = (x-1)/n and the mu multiply stay on the host.  Bit-identical to
    ``[gold.decrypt_crt(key, c) for c in cs]``; a :class:`CipherTensor`
    decrypts straight off its resident limbs.
    """
    key = bk.key
    if isinstance(cs, CipherTensor):
        if not len(cs):
            return []
        x = bi.to_ints(modexp_crt_limbs_in(bk, cs.limbs, key.lam,
                                           fixed=True))
    else:
        x = modexp_crt_vec(bk, cs, key.lam, fixed=True)
    with trace.span("paillier.decode"):
        return [(xi - 1) // key.n * key.mu % key.n for xi in x]


def matvec_many(bk: BatchKey, Ks, cs_list: Sequence) -> list:
    """Fused homomorphic matvecs: out[b][i] = prod_j cs[b][j]^{Ks[b,i,j]}.

    All B*(M, N) exponent blocks flatten into ONE batched CRT ModExp
    launch per half space, then one product-tree launch
    (``paillier_vec.mul_tree``) reduces the rows mod n^2.  Limb-resident
    in (every entry a CipherTensor) gives CipherTensor rows out; int
    sequences keep int-in/int-out.  ``Ks`` whose entries all fit int64
    stays int64 up to the device (:func:`_halves`).  Negative exponents
    force the materialized general path.
    """
    key, vk = bk.key, bk.vk
    Ks = exact_array(Ks)
    B, M, N = Ks.shape
    if len(cs_list) != B:
        raise ValueError(f"{len(cs_list)} ciphertext vectors for B={B}")
    if B == 0:
        return []
    ct_in = all(isinstance(c, CipherTensor) for c in cs_list)
    for b, row in enumerate(cs_list):
        if len(row) != N:
            raise ValueError(f"ciphertext vector {b} has {len(row)} != {N}")
    exps = Ks.reshape(-1)
    with trace.span("paillier.exps_sign"):
        negative = bool(exps.size) and exps.min() < 0
    L2 = vk.pack_n2.L16

    def tree(powed):   # (rows * N, L2) -> (rows, L2)
        return pv.mul_tree(vk, powed.reshape(-1, N, L2))

    if negative:
        rows = [int(c) for row in cs_list for c in row]  # materializes CTs
        bases = [rows[b * N + j] for b in range(B)
                 for _ in range(M) for j in range(N)]
        out = tree(modexp_crt_limbs(bk, bases, exps))
    else:
        if ct_in:
            c = torch.cat([c.limbs for c in cs_list], dim=0)
            bp = pv._reduce_into(c, vk.pack_p2)
            bq = pv._reduce_into(c, vk.pack_q2)
        else:
            with trace.span("paillier.residues"):
                rows = [int(c) for row in cs_list for c in row]
                rp = [c % key.p2 for c in rows]
                rq = [c % key.q2 for c in rows]
            bp = _limbs(bk, rp, vk.pack_p2.L16)
            bq = _limbs(bk, rq, vk.pack_q2.L16)

        def bcast(x):   # (B*N, L) -> (B*M*N, L): row b's vector, M times
            x = x.reshape(-1, 1, N, x.shape[-1])
            return x.expand(x.shape[0], M, N, x.shape[-1]).reshape(
                -1, x.shape[-1])

        # a card takes whole output rows: their N exponents each and
        # their share of the product tree
        out = _halves(bk, bcast(bp), bcast(bq), exps, None, False, group=N,
                      then=tree)
    if ct_in:
        return [CipherTensor(bk, out[b * M:(b + 1) * M]) for b in range(B)]
    ints = bi.to_ints(out)
    return [ints[b * M:(b + 1) * M] for b in range(B)]


def matvec_vec(bk: BatchKey, K, cs):
    """Single homomorphic matvec (M, N) x (N,) -> (M,), batched kernels;
    a :class:`CipherTensor` in gives one out."""
    cs = cs if isinstance(cs, CipherTensor) else list(cs)
    return matvec_many(bk, exact_array(K)[None], [cs])[0]


def warmup(bk: BatchKey, shapes: Sequence) -> dict:
    """Run the batched ops once at the given shapes, so the kernels are
    built and loaded before a measured run.

    ``shapes`` entries: an int ``B`` warms enc, dec and ⊕ at batch B; a
    ``(B, M, N)`` tuple warms the fused limb-resident matvec at 1- and
    2-limb exponent widths.  Returns ``{"calls", "seconds"}``.
    """
    t0 = time.perf_counter()
    calls = 0
    for shape in shapes:
        if isinstance(shape, (tuple, list)):
            B, M, N = (int(s) for s in shape)
            if min(B, M, N) <= 0:
                continue
            ones = CipherTensor.from_ints(bk, [1] * N)
            for val in (3, 1 << 17):   # 1- and 2-limb exponent widths
                matvec_many(bk, np.full((B, M, N), val, dtype=np.int64),
                            [ones] * B)
                calls += 1
        else:
            B = int(shape)
            if B <= 0:
                continue
            _enc_ct_impl(bk, [0] * B, [1] * B)
            ones = CipherTensor.from_ints(bk, [1] * B)
            dec_vec(bk, ones)
            add_ct(bk, ones, ones)
            calls += 3
    if bk.device.type == "cuda":
        torch.cuda.synchronize(bk.device)
    out = {"calls": calls, "seconds": time.perf_counter() - t0}
    from ..obs.metrics import record_profile
    record_profile("warmup", **out)
    return out


# ---------------------------------------------------------------------------
# Multi-key "rows" layer (serving): one launch, many tenants' keys.
#
# The functions above are keyed per BatchKey — right for a solo run, of
# no use to a serving engine fusing ops across tenants with DIFFERENT
# keys.  These run a whole cluster of same-WIDTH Paillier ops (the same
# exact byte length of n^2, :func:`rows_sig`) on the per-row-modulus
# kernels (``ops.mulmod_rows``/``modexp_rows``/``prod_rows``), where each
# row reduces mod its own tenant's n^2.  Per-tenant keys make the rows
# independent, so fusing them changes nothing but the launch count.
#
# They are PURE: no counter bumps, no rng draws — the coalescer replays
# the boxes' telemetry and blinding-draw order around them.  Formulas are
# ``paillier.encrypt_crt``/``decrypt_crt``'s, computed at n^2 without the
# CRT halves (each row carries only its tenant's n^2), in exact integer
# arithmetic, so results are bit-identical to the solo gold path.
# Ciphertexts stay limb-resident: tenants' ``CipherTensor.limbs`` of one
# width concatenate on the device, and the results come back as (rows,
# L16(n^2)) int32 tensors per tenant; decryption returns plaintext ints,
# as ``dec_vec`` does.  Nothing before that read-back waits for the
# device: host operands go up by ``bigint.to_device``, and the launch
# wrappers check row indices against ranges known on the host.
#
# ``items`` below is always one entry per tenant: ``(key, ...operands)``;
# returns are per-tenant, in the same order.
# ---------------------------------------------------------------------------

def rows_sig(key: gold.PaillierKey) -> tuple:
    """Fusion signature: ops fuse across tenants iff this matches.

    The exact byte length of n^2 (Barrett requires the top byte
    populated, so equal bit-class keys share a width)."""
    return ("pail", (key.n2.bit_length() + 7) // 8)


def _rows_cluster_width(items) -> int:
    widths = {rows_sig(item[0])[1] for item in items}
    if len(widths) != 1:
        raise ValueError(f"mismatched limb widths in one cluster: "
                         f"{sorted(widths)} (rows_sig must match)")
    return widths.pop()


def _rows_cluster(items, device, sizes):
    """(device, per-row modulus with tenant t's n^2 on ``sizes[t]`` rows,
    L16 of the width, tenant index per row)."""
    L8 = _rows_cluster_width(items)
    # the device as tensors report it (cuda:<index>), for the checks below
    dev = torch.empty(0, device=resolve_device(device)).device
    base = ops.rows_modulus([item[0].n2 for item in items], L8, dev)
    tidx = bi.to_device(np.repeat(np.arange(len(items)), sizes), dev)
    return dev, base, base.table.L16, tidx


def _rows_limbs(x, L16: int, dev: torch.device) -> torch.Tensor:
    """Ciphertexts as (B, L16) limbs on ``dev``: a CipherTensor's resident
    limbs, a limb tensor, or ints packed once."""
    if isinstance(x, CipherTensor):
        x = x.limbs
    if not isinstance(x, torch.Tensor):
        x = bi.to_device(bi.from_ints([int(v) for v in x], L16), dev)
    if x.device != dev or x.ndim != 2 or x.shape[1] > L16:
        raise ValueError(f"ciphertext rows {tuple(x.shape)} on {x.device} "
                         f"do not fit ({L16}) limbs on {dev}")
    return bi.fit(x.to(torch.int32), L16)


def _key_exps(exps: list[int], tidx: torch.Tensor) -> torch.Tensor:
    """One exponent per tenant, broadcast to its rows: (B, Le16) limbs."""
    with trace.span("paillier.exps"):
        le = max(1, max(bi.n_limbs_for(e) for e in exps))
    return bi.to_device(bi.from_ints(exps, le), tidx.device)[tidx]


def enc_rows(items: Sequence, device=None) -> list[torch.Tensor]:
    """Fused encryption: ``items = [(key, ms, rs), ...]`` -> per tenant a
    (len(ms), L16) tensor of ciphertexts.

    c = (1 + m*n) * r^n mod n^2 per row (g = n+1 form, exactly
    ``paillier.encrypt_crt``); blinding factors ``rs`` are drawn by the
    caller in each tenant's own rng order.
    """
    sizes = [len(ms) for _, ms, _ in items]
    dev, base, L16, tidx = _rows_cluster(items, device, sizes)
    rm = base.repeat(sizes)
    with trace.span("paillier.encode"):
        gms = [(1 + int(m) * key.n) % key.n2
               for key, ms, _ in items for m in ms]
    rs = [int(r) for _, _, rs in items for r in rs]
    rn = ops.modexp_rows(_rows_limbs(rs, L16, dev),
                         _key_exps([key.n for key, _, _ in items], tidx), rm)
    c = ops.mulmod_rows(_rows_limbs(gms, L16, dev), rn, rm)
    return list(torch.split(c, sizes))


def dec_rows(items: Sequence, device=None) -> list[list[int]]:
    """Fused decryption: ``items = [(key, cs), ...]`` (ciphertexts as a
    CipherTensor, limb tensor or ints) -> per tenant the plaintext ints.

    m = L(c^lam mod n^2) * mu mod n (exactly ``paillier.decrypt_crt``).
    """
    sizes = [len(cs) for _, cs in items]
    dev, base, L16, tidx = _rows_cluster(items, device, sizes)
    cs = torch.cat([_rows_limbs(c, L16, dev) for _, c in items])
    x = ops.modexp_rows(cs, _key_exps([key.lam for key, _ in items], tidx),
                        base.repeat(sizes))
    out, i = [], 0
    xs = bi.to_ints(x)
    with trace.span("paillier.decode"):
        for (key, _), n in zip(items, sizes):
            out.append([(v - 1) // key.n * key.mu % key.n
                        for v in xs[i:i + n]])
            i += n
    return out


def add_rows(items: Sequence, device=None) -> list[torch.Tensor]:
    """Fused ⊕: ``items = [(key, c1s, c2s), ...]`` -> per tenant the
    (len(c1s), L16) tensor of (c1*c2) mod n^2."""
    sizes = [len(c1) for _, c1, _ in items]
    dev, base, L16, _ = _rows_cluster(items, device, sizes)
    a = torch.cat([_rows_limbs(c1, L16, dev) for _, c1, _ in items])
    b = torch.cat([_rows_limbs(c2, L16, dev) for _, _, c2 in items])
    return list(torch.split(ops.mulmod_rows(a, b, base.repeat(sizes)),
                            sizes))


def _matvec_exps(blocks: list, dev: torch.device) -> torch.Tensor:
    """Every tenant's (E, M, N) exponent block, flattened in order, as
    (sum E M N, Le16) limbs sized to the largest exponent: int64 through
    ``paillier_vec.int64_to_limbs``, wider ints packed on the host."""
    with trace.span("paillier.exps"):
        flat = np.concatenate([np.asarray(K).reshape(-1) for K in blocks])
        fit = _int64_exps(flat)
        if fit is None:
            k64, ints = None, [int(v) for v in flat]
            lo, le = min(ints), max(bi.n_limbs_for(v) for v in ints)
        else:
            k64, lo, top = fit
            le = bi.n_limbs_for(top)
    if lo < 0:
        raise ValueError("matvec_rows requires non-negative exponents")
    if k64 is not None:
        return pv.int64_to_limbs(bi.to_device(k64, dev), le)
    return bi.to_device(bi.from_ints(ints, le), dev)


def matvec_rows(items: Sequence, device=None) -> list[torch.Tensor]:
    """Fused homomorphic matvec: ``items = [(key, Ks, cs_list), ...]``.

    Per tenant, ``Ks`` is an (E, M, N) block of NON-NEGATIVE plaintext
    exponents and ``cs_list`` holds E length-N ciphertext vectors
    (CipherTensors, limb tensors or ints); the result is an (E, M, L16)
    tensor: out[e, i] = prod_j cs[e][j]^K[e, i, j] mod n^2.  (M, N) must
    match across the cluster — it is part of the coalescer's group shape;
    callers route any negative exponent through the per-tenant path.

    Each edge's N ciphertexts are broadcast to its M rows on the device
    (as ``runtime.coalesce.c_matvec_many``), so the whole cluster is one
    ``modexp_rows`` launch at n^2 over sum E M N rows, then one shared
    ``prod_rows`` product-tree launch.
    """
    shapes = {tuple(np.shape(Ks))[1:] for _, Ks, _ in items}
    if len(shapes) != 1 or any(np.ndim(Ks) != 3 for _, Ks, _ in items):
        raise ValueError(f"matvec_rows: (M, N) blocks differ across the "
                         f"cluster: {sorted(shapes)}")
    M, N = shapes.pop()
    Es = [int(np.shape(Ks)[0]) for _, Ks, _ in items]
    dev, base, L16, _ = _rows_cluster(items, device, [1] * len(items))
    exps = _matvec_exps([Ks for _, Ks, _ in items], dev)
    bases = torch.empty((sum(Es) * M * N, L16), dtype=torch.int32,
                        device=dev)
    off = 0
    for (_, _, cs_list), E in zip(items, Es):
        if len(cs_list) != E or any(len(c) != N for c in cs_list):
            raise ValueError(f"matvec_rows: {len(cs_list)} ciphertext "
                             f"vectors for E={E}, each of N={N}")
        if E:
            cs = torch.stack([_rows_limbs(c, L16, dev) for c in cs_list])
            bases[off:off + E * M * N].view(E, M, N, L16).copy_(
                cs[:, None].expand(E, M, N, L16))
        off += E * M * N
    pw = ops.modexp_rows(bases, exps,
                         base.repeat([E * M * N for E in Es]))
    out = ops.prod_rows(pw.reshape(-1, N, L16),
                        base.repeat([E * M for E in Es]))
    return [o.reshape(E, M, L16)
            for o, E in zip(torch.split(out, [E * M for E in Es]), Es)]
