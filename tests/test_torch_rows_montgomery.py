"""The per-row-modulus ModExp under Montgomery: repro_torch vs the reference.

``ops.modexp_rows`` reduces by Montgomery by default (each table row's
-m^{-1} mod 2^32, R mod m and R^2 mod m) and by Barrett under
``REPRO_REDUCE_IMPL=barrett`` or for a table with an even modulus.  On the
CPU the port runs the kernels' plain versions; the same seeded inputs go
through the reference's jitted radix-256 ``ops.modexp_rows`` and through
Python ``pow``, with zero tolerance:

* the table's Montgomery material against ``mont_constants(m, L32, 32)``,
  and ``RowsModulus.per_row`` gathering it by row;
* ``modexp_rows`` under Montgomery over three odd moduli of 64-256 bits,
  exponents 0, 1, one whose 4-bit windows take all 16 values and random
  ones, both ladders;
* which reduction a call resolves to;
* ``enc_rows``, ``dec_rows`` and ``matvec_rows`` under both reductions.
"""
import functools
import random

import numpy as np
import pytest
import torch

from repro.core import paillier as rgold
from repro.core import paillier_batch as rpb
from repro.kernels import ops as rops
from repro_torch.core import bigint as bi
from repro_torch.core import paillier as gold
from repro_torch.core import paillier_batch as pb
from repro_torch.kernels import modexp as mx
from repro_torch.kernels import montgomery as mg
from repro_torch.kernels import ops

torch.set_num_threads(1)

#: modulus byte lengths: 64, 136, 200 and 256 bits (odd and even L8)
WIDTHS = (8, 17, 25, 32)
ALL_WINDOWS = 0xFEDCBA9876543210          # 4-bit windows 15, 14, ..., 0
B = 9


def _moduli(L8: int, n: int, seed: int, odd: bool = True) -> list:
    rng = random.Random(seed)
    return [rng.getrandbits(8 * L8) | (1 << (8 * L8 - 1)) | int(odd)
            for _ in range(n)]


def _limbs(xs, L: int) -> torch.Tensor:
    return torch.as_tensor(bi.from_ints(xs, L))


def _spy(monkeypatch) -> list:
    """Record the reduction of every ``modexp_rows_plain`` call."""
    seen, real = [], mx.modexp_rows_plain

    def plain(base, exp, rm, method, reduce_impl):
        seen.append(reduce_impl)
        return real(base, exp, rm, method, reduce_impl)

    monkeypatch.setattr(mx, "modexp_rows_plain", plain)
    return seen


@pytest.mark.parametrize("L8", WIDTHS)
def test_rows_montgomery_material(L8):
    """Each table row's mp, r1, r2 and minv are ``mont_constants``' at
    L32 words of 32 bits; ``per_row`` gathers them by the row index."""
    ms = _moduli(L8, 3, L8)
    rm = ops.rows_modulus([ms[i % 3] for i in range(5)], L8, "cpu")
    dm = rm.table
    R = 1 << (32 * dm.L32)
    assert rm.montgomery and dm.mp.dtype == torch.int32
    assert dm.mp.shape == (3,) and dm.r1.shape == dm.r2.shape == \
        dm.minv.shape == (3, dm.W)
    for t, m in enumerate(ms):
        mp, r1, r2 = mg.mont_constants(m, dm.L32, 32)
        assert int(dm.mp[t]) % (1 << 32) == mp
        assert bi.to_ints(dm.r1[t:t + 1]) == [r1]
        assert bi.to_ints(dm.r2[t:t + 1]) == [r2]
        assert bi.to_ints(dm.minv[t:t + 1]) == [(-pow(m, -1, R)) % R]
        assert m * mp % (1 << 32) == (1 << 32) - 1
    per = rm.per_row()
    idx = rm.midx.long()
    for name in ("m16", "mu16", "mw", "muw", "mp", "minv", "r1", "r2"):
        assert torch.equal(getattr(per, name), getattr(dm, name)[idx]), name
    # an even modulus anywhere in the table: no Montgomery material
    even = ops.rows_modulus([ms[0], ms[1] - 1], L8, "cpu")
    assert not even.montgomery
    assert (even.table.mp, even.table.minv, even.table.r1,
            even.table.r2) == (None, None, None, None)


@pytest.mark.parametrize("L8", WIDTHS)
@pytest.mark.parametrize("method", ("win4", "binary"))
def test_modexp_rows_montgomery_matches_reference(monkeypatch, L8, method):
    """Three odd moduli over B rows, exponents 0, 1, all 16 windows and
    random 64-bit ones: the port under Montgomery, the reference's jitted
    rows op and Python ``pow`` agree."""
    seen = _spy(monkeypatch)
    ms = _moduli(L8, 3, 100 + L8)
    per_row = [ms[i * i % 3] for i in range(B)]
    rng = random.Random(L8 * 7 + len(method))
    a = [rng.getrandbits(8 * L8) for _ in range(B)]
    exps = [0, 1, ALL_WINDOWS] + [rng.getrandbits(64) for _ in range(B - 3)]
    rm = ops.rows_modulus(per_row, L8, "cpu")
    got = bi.to_ints(ops.modexp_rows(_limbs(a, rm.table.L16),
                                     _limbs(exps, 4), rm, method=method,
                                     reduce_impl="montgomery"))
    m8, mu8 = rops.rows_modulus(per_row, L8)
    ref = rops.unpack_rows(rops.modexp_rows(
        rops.pack_rows(a, L8), rops.pack_rows(exps, 8), m8, mu8,
        method=method))
    assert got == ref == [pow(x, e, m) for x, e, m in zip(a, exps, per_row)]
    assert seen == ["montgomery"]


@pytest.mark.parametrize("env, reduce_impl, even, want", [
    (None, None, False, "montgomery"),         # the default
    ("montgomery", None, False, "montgomery"),
    ("barrett", None, False, "barrett"),       # REPRO_REDUCE_IMPL
    ("barrett", "montgomery", False, "montgomery"),  # the argument wins
    (None, "barrett", False, "barrett"),
    (None, None, True, "barrett"),             # an even table modulus
    (None, "montgomery", True, "barrett"),
])
def test_modexp_rows_resolves_reduction(monkeypatch, env, reduce_impl, even,
                                        want):
    if env is None:
        monkeypatch.delenv("REPRO_REDUCE_IMPL", raising=False)
    else:
        monkeypatch.setenv("REPRO_REDUCE_IMPL", env)
    seen = _spy(monkeypatch)
    L8 = 17
    ms = _moduli(L8, 2, 5)
    if even:
        ms[1] -= 1
    per_row = [ms[i % 2] for i in range(4)]
    rng = random.Random(3)
    a = [rng.getrandbits(8 * L8) for _ in range(4)]
    exps = [rng.getrandbits(32) for _ in range(4)]
    rm = ops.rows_modulus(per_row, L8, "cpu")
    got = ops.modexp_rows(_limbs(a, rm.table.L16), _limbs(exps, 2), rm,
                          reduce_impl=reduce_impl)
    assert seen == [want]
    assert bi.to_ints(got) == [pow(x, e, m)
                               for x, e, m in zip(a, exps, per_row)]


def test_modexp_rows_refuses_bad_reductions(monkeypatch):
    ms = _moduli(17, 2, 6)
    x = torch.ones((2, 9), dtype=torch.int32)
    rm = ops.rows_modulus(ms, 17, "cpu")
    with pytest.raises(ValueError, match="unknown reduce_impl"):
        ops.modexp_rows(x, x[:, :1], rm, reduce_impl="sideways")
    monkeypatch.setenv("REPRO_REDUCE_IMPL", "sideways")
    with pytest.raises(ValueError, match="REPRO_REDUCE_IMPL"):
        ops.modexp_rows(x, x[:, :1], rm)
    even = ops.rows_modulus([ms[0], ms[1] - 1], 17, "cpu")
    with pytest.raises(ValueError, match="every table modulus odd"):
        mx.modexp_rows_plain(x, x[:, :1], even, "win4", "montgomery")


@functools.lru_cache(maxsize=None)
def _key_pair(bits: int, seed: int):
    return (gold.keygen(bits, random.Random(seed)),
            rgold.keygen(bits, random.Random(seed)))


@pytest.mark.parametrize("bits", (64, 128))
@pytest.mark.parametrize("impl", ("montgomery", "barrett"))
def test_rows_paillier_ops_under_both_reductions(monkeypatch, bits, impl):
    """Two keys of one n^2 width fused: enc_rows, dec_rows and
    matvec_rows equal the reference's under either reduction, and their
    ModExps ran under it."""
    monkeypatch.setenv("REPRO_REDUCE_IMPL", impl)
    seen = _spy(monkeypatch)
    (p1, r1), (p2, r2) = _key_pair(bits, 11), _key_pair(bits, 12)
    if rpb.rows_sig(r1) != rpb.rows_sig(r2):
        pytest.skip("the two keys' n^2 differ in byte length")
    rng = random.Random(bits)
    ms1 = [0, 1, 2 ** 30, 999, 5]
    ms2 = [rng.randrange(p2.n) for _ in range(3)]
    rs1 = [rgold.rand_r(r1, rng) for _ in ms1]
    rs2 = [rgold.rand_r(r2, rng) for _ in ms2]
    c1, c2 = pb.enc_rows([(p1, ms1, rs1), (p2, ms2, rs2)], device="cpu")
    R1, R2 = rpb.enc_rows([(r1, ms1, rs1), (r2, ms2, rs2)])
    assert (bi.to_ints(c1), bi.to_ints(c2)) == (R1, R2)
    assert pb.dec_rows([(p1, c1), (p2, c2)], device="cpu") == \
        rpb.dec_rows([(r1, R1), (r2, R2)]) == [ms1, ms2]
    Ks1 = np.array([[[rng.getrandbits(30) for _ in range(3)]
                     for _ in range(2)]], dtype=object)
    Ks2 = np.array([[[0, 0, 5], [1, 2, 3]], [[7, 0, 0], [0, 0, 0]]],
                   dtype=object)
    got = pb.matvec_rows([(p1, Ks1, [c1[:3]]),
                          (p2, Ks2, [c2[:3], R2[:3]])], device="cpu")
    ref = rpb.matvec_rows([(r1, Ks1, [R1[:3]]),
                           (r2, Ks2, [R2[:3], R2[:3]])])
    assert [[bi.to_ints(rows) for rows in t] for t in got] == ref
    assert seen == [impl] * 3
