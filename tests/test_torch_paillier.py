"""repro_torch batched Paillier vs the JAX reference and the scalar gold path.

The same key (the reference's, carried over by ``convert``) and the same
``random.Random`` seed go through ``repro.core.paillier_batch`` and
``repro_torch.core.paillier_batch`` on the CPU: ``enc_ct``, ``add_ct``,
``matvec_vec`` and ``dec_vec`` give the same ciphertext ints, leave the
rng in the same state, round-trip the plaintexts and convert between
ints and limbs only at phase boundaries.  Tolerance: none (exact
integer arithmetic).  The ⊗-matvec's exponent paths (int64 straight to
the device, or reduced mod phi on the host) give the scalar gold loop's
ciphertexts.
"""
import dataclasses
import functools
import math
import random

import numpy as np
import pytest
import torch

from repro.core import paillier as rgold
from repro.core import paillier_batch as rpb
from repro_torch.convert import key_from_reference, limbs_from_numpy
from repro_torch.core import cipher_tensor as ctm
from repro_torch.core import paillier as gold
from repro_torch.core import paillier_batch as pb
from repro_torch.core import paillier_vec as pv
from repro_torch.core import protocol
from repro_torch.obs import metrics as obs_metrics

# small tensors: one intra-op thread avoids oversubscribing the cores that
# the suite's parallel workers share
torch.set_num_threads(1)

BITS = (128, 256)


@pytest.fixture(scope="module", params=BITS)
def keys(request):
    bits = request.param
    ref_key = rgold.keygen(bits, random.Random(bits))
    key = key_from_reference(dataclasses.asdict(ref_key))
    return bits, ref_key, key


def _units(key, rng, count):
    out = []
    while len(out) < count:
        c = rng.randrange(1, key.n2)
        if math.gcd(c, key.n) == 1:
            out.append(c)
    return out


def test_keygen_and_key_conversion_match_reference(keys):
    bits, ref_key, key = keys
    assert dataclasses.asdict(key) == dataclasses.asdict(ref_key)
    assert gold.keygen(bits, random.Random(bits)) == key
    with pytest.raises(KeyError):
        key_from_reference({"n": key.n})


def test_enc_add_matvec_dec_chain_equals_reference(keys):
    bits, ref_key, key = keys
    rbk = rpb.make_batch_key(ref_key)
    bk = pb.make_batch_key(key, "cpu")
    pick = random.Random(bits + 1)
    B, M = 8, 8     # one batch shape: the reference compiles dec once
    ms1 = [pick.randrange(1 << 40) for _ in range(B)]
    ms2 = [pick.randrange(1 << 40) for _ in range(B)]
    K = np.array([[pick.randrange(1 << 20) for _ in range(B)]
                  for _ in range(M)], dtype=object)
    r_ref, r_port = random.Random(bits), random.Random(bits)

    ctm.reset_conversion_stats()
    c1 = pb.enc_ct(bk, ms1, r_port)
    c2 = pb.enc_ct(bk, ms2, r_port)
    s = pb.add_ct(bk, c1, c2)
    t = pb.matvec_vec(bk, K, s)
    dec_s = pb.dec_vec(bk, s)
    dec_t = pb.dec_vec(bk, t)
    # limb-resident from encryption to decryption: no ciphertext went
    # through Python ints in between
    assert ctm.CONVERSIONS == {"to_ints": 0, "from_ints": 0}
    assert isinstance(t, ctm.CipherTensor) and t.limbs.device.type == "cpu"

    e1 = rpb.enc_ct(rbk, ms1, r_ref)
    e2 = rpb.enc_ct(rbk, ms2, r_ref)
    es = rpb.add_ct(rbk, e1, e2)
    et = rpb.matvec_vec(rbk, K, es)
    assert c1.to_ints() == e1.to_ints()
    assert c2.to_ints() == e2.to_ints()
    assert s.to_ints() == es.to_ints()
    assert t.to_ints() == et.to_ints()
    assert r_port.getstate() == r_ref.getstate()
    assert dec_s == rpb.dec_vec(rbk, es) == [a + b for a, b in zip(ms1, ms2)]
    want = [sum(int(K[i, j]) * (ms1[j] + ms2[j]) for j in range(B)) % key.n
            for i in range(M)]
    assert dec_t == rpb.dec_vec(rbk, et) == want
    # the scalar gold path agrees on the blinding stream as well
    r_gold = random.Random(bits)
    assert c1.to_ints() == [gold.encrypt_crt(key, m, gold.rand_r(key, r_gold))
                            for m in ms1]


def test_reference_limbs_decrypt_in_the_port(keys):
    """Ciphertext limbs produced by the reference decrypt in the port."""
    bits, ref_key, key = keys
    rbk = rpb.make_batch_key(ref_key)
    bk = pb.make_batch_key(key, "cpu")
    ms = list(range(100, 108))
    ref_ct = rpb.enc_ct(rbk, ms, random.Random(5))
    limbs = limbs_from_numpy(np.asarray(ref_ct.limbs), "cpu")
    assert pb.dec_vec(bk, ctm.CipherTensor(bk, limbs)) == ms


def test_pow_and_matvec_int_paths_equal_scalar_gold(keys):
    """Int-in/int-out paths, negative exponents (host base inversion) and
    exponents far above phi(p^2), against Python ``pow``."""
    bits, _, key = keys
    bk = pb.make_batch_key(key, "cpu")
    rng = random.Random(bits + 2)
    cs = _units(key, rng, 8)
    ks = [rng.randrange(1 << 21) for _ in range(5)] + [0, -7, 1 << 300]
    assert pb.pow_c_vec(bk, cs, ks) == \
        [pow(c, k, key.n2) for c, k in zip(cs, ks)]
    assert pb.modexp_crt_vec(bk, cs, 65537, fixed=True) == \
        [pow(c, 65537, key.n2) for c in cs]
    Km = np.array([[rng.randrange(1 << 16) for _ in range(8)]
                   for _ in range(2)], dtype=object)
    Km[1, 3] = -Km[1, 3]
    want = []
    for i in range(2):
        acc = 1
        for j in range(8):
            acc = acc * pow(cs[j], int(Km[i, j]), key.n2) % key.n2
        want.append(acc)
    assert pb.matvec_vec(bk, Km, cs) == want
    ct = ctm.CipherTensor.from_ints(bk, cs)
    assert pb.pow_c_ct(bk, ct, 3).to_ints() == [pow(c, 3, key.n2) for c in cs]


def test_vec_module_round_trip(keys):
    """paillier_vec: int64 plaintexts through encrypt/⊕/⊗-matvec/decrypt."""
    bits, _, key = keys
    vk = pb.make_batch_key(key, "cpu").vk
    rng = random.Random(bits + 3)
    m = torch.tensor([rng.randrange(1 << 20) for _ in range(6)])
    rs = [gold.rand_r(key, rng) for _ in range(6)]
    rn = limbs_from_numpy(pv.bi.from_ints(
        [pow(r, key.n, key.n2) for r in rs], vk.pack_n2.L16), "cpu")
    c = pv.encrypt_batch(vk, m, rn)
    assert pv.bi.to_ints(c) == [gold.encrypt(key, int(x), r)
                                for x, r in zip(m, rs)]
    K = torch.tensor([[1, 2, 3, 4, 5, 6], [0, 0, 0, 0, 0, 1]])
    out = pv.decrypt_batch(vk, pv.c_matvec(vk, K, pv.c_add_batch(vk, c, c)))
    assert out.tolist() == (K @ (2 * m)).tolist()


def test_empty_and_device_errors(keys):
    _, _, key = keys
    bk = pb.make_batch_key(key, "cpu")
    empty = pb.enc_ct(bk, [], random.Random(0))
    assert len(empty) == 0 and empty.to_ints() == []
    assert pb.dec_vec(bk, empty) == []
    assert pb.matvec_many(bk, np.zeros((0, 2, 3), dtype=object), []) == []
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            pb.make_batch_key(key)


# ---------------------------------------------------------------------------
# The ⊗-matvec's exponents: int64 to the device, or reduced on the host
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _key(bits):
    return gold.keygen(bits, random.Random(bits))


def _exps_block(case, rng, shape):
    """(key bits, exponent block, the PROCESS counter it must move)."""
    def draw(bits):
        return np.array([rng.randrange(1 << bits)
                         for _ in range(math.prod(shape))],
                        dtype=np.int64).reshape(shape)
    if case == "int64_1_limb":
        return 128, draw(16), "exps.int64"
    if case == "int64_3_limbs":
        return 128, draw(40), "exps.int64"
    if case == "object_fits_int64":
        return 128, draw(62).astype(object), "exps.int64"
    if case == "object_wider_than_int64":
        K = draw(40).astype(object)
        K.flat[1] = (1 << 70) + 3
        return 128, K, "exps.reduced"
    if case == "negative":   # bases inverted on the host, then int64
        K = draw(20)
        K.flat[2] = -K.flat[2] - 1
        return 128, K, "exps.int64"
    if case == "max_above_phi":   # a 32-bit key: phi(p^2) ~ 2^32
        return 32, draw(40), "exps.reduced"
    raise ValueError(case)


EXP_CASES = ("int64_1_limb", "int64_3_limbs", "object_fits_int64",
             "object_wider_than_int64", "negative", "max_above_phi")


def _scalar_matvec(key, K, cs):
    box = protocol.GoldBox(key, random.Random(0), batch=False,
                           device="cpu")
    return box.matvec(K, cs)


@pytest.mark.parametrize("entry", ["matvec_many", "matvec_vec"])
@pytest.mark.parametrize("case", EXP_CASES)
def test_matvec_exponent_paths_equal_scalar_gold_and_object_path(
        case, entry, monkeypatch):
    """Each exponent block gives the scalar gold loop's ciphertexts, and
    the object-array path's (``_int64_exps`` off), bit for bit, and moves
    the ``PROCESS`` counter of the path it took by its exponent count."""
    B, M, N = (2, 3, 4) if entry == "matvec_many" else (1, 3, 4)
    rng = random.Random(f"{case}/{entry}")
    bits, Ks, counter = _exps_block(case, rng, (B, M, N))
    key = _key(bits)
    if case == "max_above_phi":
        assert Ks.max() >= min(key.phi_p2, key.phi_q2)
    bk = pb.make_batch_key(key, "cpu")
    cs = [_units(key, rng, N) for _ in range(B)]
    want = [_scalar_matvec(key, Ks[b], cs[b]) for b in range(B)]
    materialized = []
    modexp = pb.modexp_crt_limbs
    monkeypatch.setattr(pb, "modexp_crt_limbs", lambda *a, **k: (
        materialized.append(1), modexp(*a, **k))[1])

    def run():
        if entry == "matvec_vec":
            return [pb.matvec_vec(bk, Ks[0], ctm.CipherTensor.from_ints(
                bk, cs[0])).to_ints()]
        return pb.matvec_many(bk, Ks, cs)

    before = dict(obs_metrics.PROCESS.counters)
    got = run()
    assert obs_metrics.PROCESS.since(before, "exps.") == {counter: B * M * N}
    assert got == want
    assert bool(materialized) == (case == "negative")
    monkeypatch.setattr(pb, "_int64_exps", lambda exps: None)
    before = dict(obs_metrics.PROCESS.counters)
    assert run() == want
    assert obs_metrics.PROCESS.since(before, "exps.") == \
        {"exps.reduced": B * M * N}


@pytest.mark.parametrize("entry", ["pow_c_vec", "pow_c_ct", "modexp_crt_vec"])
@pytest.mark.parametrize("bits,counter", [(128, "exps.int64"),
                                          (32, "exps.reduced")])
def test_per_element_modexp_exponent_paths_equal_pow(entry, bits, counter):
    """Per-element exponents of the batched CRT ModExp outside the matvec
    take the same two paths: int64 below both phi to the device, any
    other list reduced on the host; either gives ``pow`` bit for bit."""
    key = _key(bits)
    bk = pb.make_batch_key(key, "cpu")
    rng = random.Random(f"{entry}/{bits}")
    cs = _units(key, rng, 6)
    ks = [rng.randrange(1 << 40) for _ in cs]
    if entry == "modexp_crt_vec":   # a negative one: its base inverted
        ks[1] = -ks[1]
    before = dict(obs_metrics.PROCESS.counters)
    if entry == "pow_c_ct":
        got = pb.pow_c_ct(bk, ctm.CipherTensor.from_ints(bk, cs),
                          ks).to_ints()
    else:
        got = getattr(pb, entry)(bk, cs, ks)
    assert got == [pow(c, k, key.n2) for c, k in zip(cs, ks)]
    assert obs_metrics.PROCESS.since(before, "exps.") == {counter: len(cs)}
