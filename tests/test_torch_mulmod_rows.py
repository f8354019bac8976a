"""The per-row-modulus mulmod under Montgomery: repro_torch vs the reference.

``ops.mulmod_rows`` follows the moduli: two Montgomery products (REDC of
a * (R^2 mod m), then of that times b) when every table modulus is odd,
Barrett for a table with an even modulus.  On the CPU the port runs the
kernel's plain versions; the same seeded inputs go through the
reference's jitted radix-256 ``ops.mulmod_rows`` (and ``paillier_batch``
``enc_rows``/``add_rows``) and through Python ints, with zero tolerance:

* ``mulmod_rows`` at k = 64 and 128 words (n^2 of 1,024- and 2,048-bit
  keys) over tables of one modulus, of four, and of four with one even,
  against the reference and ints; operands of the full width, which the
  reference cuts at an odd byte length (its ``ops.py:126-130``), against
  ints only;
* ``enc_rows`` and ``add_rows`` of four tenants against the reference's;
* a Python-int model of the CUDA body's order (limbs.cuh ``mont_mul``,
  word by word): both products' precondition a * b < R m and the CIOS
  sum's bound below 2m, and the result, at a = b = R - 1, the smallest
  and largest odd modulus of each byte length and operands at and above
  m; the same model under hypothesis;
* the row index's range check (``build.require_index``) for every way a
  ``RowsModulus`` is built, none of which reads the index back.
"""
import dataclasses
import functools
import random

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, strategies as st
from repro.core import paillier as rgold
from repro.core import paillier_batch as rpb
from repro.kernels import ops as rops
from repro_torch.core import bigint as bi
from repro_torch.core import paillier as gold
from repro_torch.core import paillier_batch as pb
from repro_torch.kernels import build
from repro_torch.kernels import common as cm
from repro_torch.kernels import limb_mulmod as lm
from repro_torch.kernels import ops
from repro_torch.kernels import prodtree

torch.set_num_threads(1)

#: the serving path's widths in 32-bit words: n^2 of 1,024- and 2,048-bit
#: keys
WORDS = (64, 128)
B = 8
MASK = (1 << 32) - 1


def _moduli(L8: int, n: int, seed: int, even: bool = False) -> list:
    """n odd moduli of exactly L8 bytes (the last even when ``even``)."""
    rng = random.Random(seed)
    ms = [rng.getrandbits(8 * L8) | (1 << (8 * L8 - 1)) | 1
          for _ in range(n)]
    if even:
        ms[-1] -= 1
    return ms


def _limbs(xs, L: int) -> torch.Tensor:
    return torch.as_tensor(bi.from_ints(xs, L))


def _spy(monkeypatch) -> list:
    """Record the reduction of every ``mulmod_rows_plain`` call."""
    seen, real = [], lm.mulmod_rows_plain

    def plain(a, b, rm, reduce_impl=None):
        seen.append(lm.rows_reduction(rm, reduce_impl))
        return real(a, b, rm, reduce_impl)

    monkeypatch.setattr(lm, "mulmod_rows_plain", plain)
    return seen


@pytest.mark.parametrize("k", WORDS)
@pytest.mark.parametrize("T, even", [(1, False), (4, False), (4, True)])
def test_mulmod_rows_matches_reference(monkeypatch, k, T, even):
    """Seeded numpy operands below 2^{32k} (the reference's full width at
    these even byte lengths), one, four and four-with-one-even moduli:
    the port, the reference's rows op and ints agree; the body follows
    the moduli."""
    seen = _spy(monkeypatch)
    L8 = 4 * k
    ms = _moduli(L8, T, 10 * k + T + even, even)
    per_row = [ms[(i * 3) % T] for i in range(B)]
    gen = np.random.default_rng(k + T + even)
    raw = gen.integers(0, 256, size=(2, B, L8), dtype=np.int64)
    a, b = ([int.from_bytes(bytes(row.astype(np.uint8).tolist()), "little")
             for row in x] for x in raw)
    a[0] = b[0] = (1 << (8 * L8)) - 1           # R - 1
    a[1], b[1] = per_row[1], per_row[1] + 1     # at and above m
    rm = ops.rows_modulus(per_row, L8, "cpu")
    L16 = rm.table.L16
    got = bi.to_ints(ops.mulmod_rows(_limbs(a, L16), _limbs(b, L16), rm))
    m8, mu8 = rops.rows_modulus(per_row, L8)
    ref = rops.unpack_rows(rops.mulmod_rows(
        rops.pack_rows(a, L8), rops.pack_rows(b, L8), m8, mu8))
    assert got == ref == [x * y % m for x, y, m in zip(a, b, per_row)]
    assert seen == ["barrett" if even else "montgomery"]


@pytest.mark.parametrize("L8", (255, 511))
def test_mulmod_rows_full_width_operands_odd_bytes(L8):
    """At an odd byte length the limbs hold more than the modulus' bytes:
    operands up to 2^{16 L16} - 1, which the reference would cut, against
    ints under both reductions."""
    ms = _moduli(L8, 3, L8)
    per_row = [ms[i % 3] for i in range(6)]
    rm = ops.rows_modulus(per_row, L8, "cpu")
    L16 = rm.table.L16
    top = (1 << (16 * L16)) - 1
    rng = random.Random(L8)
    a = [top, top, ms[0], 0, 1] + [rng.getrandbits(16 * L16)]
    b = [top, 1, ms[1] * 2, top, top] + [rng.getrandbits(16 * L16)]
    want = [x * y % m for x, y, m in zip(a, b, per_row)]
    for impl in ("montgomery", "barrett"):
        got = lm.mulmod_rows_plain(_limbs(a, L16), _limbs(b, L16), rm, impl)
        assert bi.to_ints(got) == want, impl


@functools.lru_cache(maxsize=None)
def _keys(bits: int, seeds: tuple) -> tuple:
    return tuple((gold.keygen(bits, random.Random(s)),
                  rgold.keygen(bits, random.Random(s))) for s in seeds)


def test_enc_and_add_rows_match_reference(monkeypatch):
    """Four 1,024-bit tenants (n^2 of k = 64 words) fused: enc_rows and
    add_rows equal the reference's, and their products ran Montgomery."""
    seen = _spy(monkeypatch)
    pairs = [p for p in _keys(1024, (21, 22, 23, 24, 25, 26))
             if rpb.rows_sig(p[1]) == ("pail", 256)][:4]
    assert len(pairs) == 4
    rng = random.Random(4)
    sizes = (3, 1, 2, 2)
    ms = [[rng.randrange(r.n) for _ in range(n)]
          for (_, r), n in zip(pairs, sizes)]
    rs = [[rgold.rand_r(r, rng) for _ in m] for (_, r), m in zip(pairs, ms)]
    got = pb.enc_rows([(p, m, r) for (p, _), m, r in zip(pairs, ms, rs)],
                      device="cpu")
    ref = rpb.enc_rows([(r, m, x) for (_, r), m, x in zip(pairs, ms, rs)])
    assert [bi.to_ints(c) for c in got] == ref
    c2 = [[rng.randrange(r.n2) for _ in m] for (_, r), m in zip(pairs, ms)]
    got = pb.add_rows([(p, c, _limbs(d, c.shape[1]))
                       for (p, _), c, d in zip(pairs, got, c2)],
                      device="cpu")
    ref = rpb.add_rows([(r, c, d) for (_, r), c, d in zip(pairs, ref, c2)])
    assert [bi.to_ints(c) for c in got] == ref
    assert seen == ["montgomery", "montgomery"]


# ---------------------------------------------------------------------------
# the CUDA body's order, word by word, on Python ints
# ---------------------------------------------------------------------------

def _words(L8: int) -> int:
    """k: the kernels' width in 32-bit words of an L8-byte modulus
    (ceil(L16 / 2), L16 = ceil(L8 / 2))."""
    return (L8 + 3) // 4


def _cios(a: int, b: int, m: int, k: int) -> int:
    """limbs.cuh mont_mul on ints: a * b * 2^{-32k} mod m, word by word
    over b, with its precondition a * b < R m and the sum's bound below
    2m before the one conditional subtraction."""
    R = 1 << (32 * k)
    assert 0 <= a < R and 0 <= b < R and a * b < R * m, "mont_mul bound"
    mp = -pow(m, -1, 1 << 32) & MASK
    t = 0
    for i in range(k):
        t += a * ((b >> (32 * i)) & MASK)
        u = (t & MASK) * mp & MASK
        t = (t + u * m) >> 32
    assert t < 2 * m
    return t - m if t >= m else t


def _two_products(a: int, b: int, m: int) -> int:
    """The Montgomery body: t = REDC(a (R^2 mod m)) = a R mod m, then
    REDC(t b) = a b mod m."""
    k = _words(-(-m.bit_length() // 8))
    R = 1 << (32 * k)
    t = _cios(a, R * R % m, m, k)
    assert t == a * R % m
    return _cios(t, b, m, k)


#: byte lengths from one byte to n^2 of a 2,048-bit key, odd and even
BYTE_LENGTHS = (1, 2, 3, 4, 5, 8, 17, 64, 255, 256, 511, 512)


@pytest.mark.parametrize("L8", BYTE_LENGTHS)
def test_two_products_at_adversarial_operands(L8):
    """The smallest and largest odd modulus of L8 bytes, a = b = R - 1,
    operands equal to m, above m and the largest below 2^{16 L16}: both
    products keep mont_mul's bound and give a b mod m; the port's plain
    Montgomery mulmod_rows gives the same.  REDC(a b) first would break
    the bound at a = b = R - 1 for every m below R - 1."""
    k = _words(L8)
    R = 1 << (32 * k)
    L16 = -(-L8 // 2)
    top = (1 << (16 * L16)) - 1
    for m in (max(3, (1 << (8 * (L8 - 1))) + 1), (1 << (8 * L8)) - 1):
        pairs = [(R - 1, R - 1), (top, top), (m, m), (m, m + 1),
                 (m + 1, top), (m - 1, m - 1), (0, top), (1, m + 2)]
        pairs = [(a, b) for a, b in pairs if a <= top and b <= top]
        for a, b in pairs:
            assert _two_products(a, b, m) == a * b % m, (L8, m, a, b)
        if (R - 1) ** 2 >= R * m:        # every m below R - 1
            with pytest.raises(AssertionError, match="mont_mul bound"):
                _cios(R - 1, R - 1, m, k)
        rm = ops.rows_modulus([m] * len(pairs), L8, "cpu")
        got = lm.mulmod_rows_plain(_limbs([a for a, _ in pairs], L16),
                                   _limbs([b for _, b in pairs], L16), rm)
        assert bi.to_ints(got) == [a * b % m for a, b in pairs]


@settings(max_examples=40, deadline=None)
@given(st.integers(1, 512), st.integers(0, 2 ** 64), st.integers(0, 2 ** 64),
       st.integers(0, 2 ** 64))
def test_two_products_hypothesis(L8, ms, sa, sb):
    """Any odd modulus of L8 bytes and any operands below R: the model's
    bounds hold and it gives a b mod m."""
    k = _words(L8)
    R = 1 << (32 * k)
    m = random.Random(ms).getrandbits(8 * L8) | (1 << (8 * L8 - 1)) | 1
    if m < 3:
        m = 3
    a = random.Random(sa).randrange(R)
    b = random.Random(sb).randrange(R)
    assert _two_products(a, b, m) == a * b % m


# ---------------------------------------------------------------------------
# the row index: checked against a range known on the host
# ---------------------------------------------------------------------------

def _table(T: int = 2):
    return ops.rows_modulus(_moduli(17, T, 9), 17, "cpu")


def test_rows_modulus_and_repeat_note_the_range():
    """rows_modulus notes [0, T) from its host ints; repeat carries it
    (counts of 0 drop rows) and knows its output size."""
    rm = ops.rows_modulus([m for m in _moduli(17, 3, 9) for _ in (0, 1)],
                          17, "cpu")
    assert cm.index_range(rm.midx) == (0, 2)
    rep = rm.repeat([1, 0, 2, 0, 0, 3])
    assert rep.midx.tolist() == [0, 1, 1, 2, 2, 2]
    assert cm.index_range(rep.midx) == (0, 2)
    assert cm.index_range(rm.repeat([0] * 6).midx) is None
    assert build.require_index("t", rep, 6, torch.device("cpu")) is rep.midx
    with pytest.raises(ValueError, match="non-negative counts"):
        rm.repeat([1, -1, 0, 0, 0, 0])
    with pytest.raises(ValueError, match="non-negative counts"):
        rm.repeat([1, 2])


def _bad_ways(rm):
    """A RowsModulus whose index names row T of a T-row table, built each
    way one can be built."""
    T = len(rm.moduli)
    bad = torch.tensor([0, T, 1], dtype=torch.int32)
    yield "constructor", cm.RowsModulus(rm.table, bad, rm.moduli)
    yield "replace", dataclasses.replace(rm, midx=bad.clone())
    yield "repeat", cm.RowsModulus(rm.table, bad.clone(),
                                   rm.moduli).repeat([1, 1, 1])
    noted = cm.note_index_range(bad.clone(), 0, T)
    yield "noted", cm.RowsModulus(rm.table, noted, rm.moduli)


@pytest.mark.parametrize("way", ["constructor", "replace", "repeat", "noted"])
def test_out_of_range_index_raises_every_way(way):
    rm = _table()
    built = dict(_bad_ways(rm))[way]
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="outside the table"):
        build.require_index("t", built, 3, cpu)
    with pytest.raises(ValueError, match="outside the table"):
        prodtree._require_table("prod_rows", built.table, built.midx, True,
                                torch.zeros((2, built.table.W),
                                            dtype=torch.int32), 3, cpu)


def test_index_written_in_place_raises():
    """The range was noted for the index as built: an index written in
    place since is refused, not read back."""
    rm = ops.rows_modulus(_moduli(17, 2, 9) * 2, 17, "cpu")
    cpu = torch.device("cpu")
    assert build.require_index("t", rm, 4, cpu) is rm.midx
    rm.midx[0] = 1
    with pytest.raises(ValueError, match="written in place"):
        build.require_index("t", rm, 4, cpu)
    with pytest.raises(ValueError, match="written in place"):
        rm.repeat(2)


def test_to_device_on_the_cpu():
    """bigint.to_device keeps values and dtype; on the CPU it is
    torch.as_tensor."""
    arr = np.arange(6, dtype=np.int32).reshape(2, 3)
    t = bi.to_device(arr, "cpu")
    assert t.dtype == torch.int32 and t.tolist() == arr.tolist()
    assert bi.to_device([5, 7], torch.device("cpu")).tolist() == [5, 7]
