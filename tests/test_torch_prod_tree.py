"""The product tree: repro_torch's one-launch ``prod_rows`` and ``mul_tree``
vs the reference's log-depth trees.

``ops.prod_rows`` (per-row moduli) and ``paillier_vec.mul_tree`` (one
modulus, ``ops.prod_mod``) run one launch of ``csrc/prodtree.cu`` a
product on the card; on the CPU they run its plain version
(``kernels/prodtree.prod_rows_plain``), the same algorithm: G groups fold
the factors, a tree halves the groups, and under Montgomery the groups
start at R mod m and one last product by R^N mod m undoes the tree's
R^{1-N}.  The same seeded inputs go through the reference's jitted
radix-256 ``ops.prod_rows``, its ``paillier_vec.mul_tree`` (the default
jnp backend, and the Pallas ``mulmod`` kernel in interpret mode), the
port and Python ints, with zero tolerance:

* N in {1, 2, 3, 5, 16, 17, 192}, tables of 1-4 moduli of 16, 32 and 64
  bytes, factors at full width (below 2^{8 L8}, so most are >= m, and
  2^{8 L8} - 1);
* the plain tree at G in {1, 2, 4, 16, 256} (more groups than factors),
  both reductions, an odd byte length whose factors reach 2^{16 L16} - 1;
* N = 1 returns its input unchanged (a factor >= m included), R = 0 an
  empty tensor;
* an even modulus takes the Barrett body, ``REPRO_REDUCE_IMPL=barrett``
  leaves odd moduli on Montgomery (the reference's tree never reads it);
  the R^N correction is cached by (table, N, device);
* the launch geometry and the operand checks.
"""
import dataclasses
import random

import numpy as np
import pytest
import torch

from repro.core import paillier as rgold
from repro.core import paillier_vec as rpv
from repro.kernels import ops as rops
from repro_torch.core import bigint as bi
from repro_torch.core import paillier as gold
from repro_torch.core import paillier_vec as pv
from repro_torch.kernels import build, geometry, ops, prodtree

torch.set_num_threads(1)

GROUPS = (1, 2, 4, 16, 256)
NS = (1, 2, 3, 5, 16, 17, 192)


def _moduli(L8: int, n: int, seed: int, odd: bool = True) -> list:
    rng = random.Random(seed)
    return [(rng.getrandbits(8 * L8) | (1 << (8 * L8 - 1)) | 1) - (not odd)
            for _ in range(n)]


def _limbs(xs, L: int) -> torch.Tensor:
    return torch.as_tensor(bi.from_ints(xs, L))


def _factors(rng, R: int, N: int, bits: int) -> list:
    """R*N factors below 2^bits, the first one 2^bits - 1."""
    xs = [rng.getrandbits(bits) for _ in range(R * N)]
    xs[0] = (1 << bits) - 1
    return xs


def _want(xs, N: int, per_row) -> list:
    out = []
    for r, m in enumerate(per_row):
        p = 1
        for v in xs[r * N:(r + 1) * N]:
            p = p * v % m
        out.append(p if N > 1 else xs[r * N])
    return out


def _spy(monkeypatch) -> list:
    """Record (reduce_impl, groups) of every plain tree."""
    seen, real = [], prodtree.prod_rows_plain

    def plain(x, table, midx, reduce_impl, groups, corr=None):
        seen.append((reduce_impl, groups))
        return real(x, table, midx, reduce_impl, groups, corr)

    monkeypatch.setattr(prodtree, "prod_rows_plain", plain)
    return seen


@pytest.mark.parametrize("L8, N, T", [
    (16, 1, 1), (16, 2, 2), (32, 3, 3), (32, 5, 4), (64, 16, 1),
    (64, 17, 2), (32, 192, 4), (16, 192, 3)])
def test_prod_rows_matches_reference_and_ints(L8, N, T):
    """T moduli cycling over 5 rows, full-width factors: the port's
    one-launch product equals the reference's radix-256 tree and ints."""
    R = 5
    ms = _moduli(L8, T, L8 * 7 + N)
    per_row = [ms[i % T] for i in range(R)]
    rng = random.Random(N * 31 + L8)
    xs = _factors(rng, R, N, 8 * L8)
    rm = ops.rows_modulus(per_row, L8, "cpu")
    L16 = rm.table.L16
    got = bi.to_ints(ops.prod_rows(_limbs(xs, L16).reshape(R, N, L16), rm))
    m8, mu8 = rops.rows_modulus(per_row, L8)
    ref = rops.unpack_rows(rops.prod_rows(
        np.asarray(rops.pack_rows(xs, L8)).reshape(R, N, L8), m8, mu8))
    assert got == ref == _want(xs, N, per_row)


@pytest.mark.parametrize("L8", (16, 17, 32, 64))
@pytest.mark.parametrize("impl", ("montgomery", "barrett"))
def test_plain_tree_every_group_count(L8, impl):
    """The plain tree at every G and N (G > N included) equals ints: the
    Montgomery bookkeeping (start at R mod m, N + G - 1 products, one
    R^N) holds whatever the split.  L8 = 17 has factors up to
    2^{16 L16} - 1 > 2^{8 L8}."""
    T = 1 + L8 % 4
    R = 4
    ms = _moduli(L8, T, L8)
    per_row = [ms[i % T] for i in range(R)]
    rm = ops.rows_modulus(per_row, L8, "cpu")
    L16, L32 = rm.table.L16, rm.table.L32
    rng = random.Random(L8 + len(impl))
    for N in NS[1:]:
        xs = _factors(rng, R, N, 16 * L16)
        x = _limbs(xs, L16).reshape(R, N, L16)
        corr = ops._tree_correction(rm.moduli, L32, N, "cpu")
        want = _want(xs, N, per_row)
        for G in GROUPS:
            got = prodtree.prod_rows_plain(x, rm.table, rm.midx, impl, G,
                                           corr)
            assert got.dtype == torch.int32 and got.shape == (R, L16)
            assert bi.to_ints(got) == want, (N, G)


def test_one_factor_returns_input_unchanged(monkeypatch):
    """N = 1: row r's only factor as it is, even above m, with no tree
    (as the reference's ``_prod_rows8`` and ``mul_tree`` do)."""
    seen = _spy(monkeypatch)
    L8 = 16
    ms = _moduli(L8, 2, 5)
    rm = ops.rows_modulus(ms, L8, "cpu")
    x = _limbs([(1 << 128) - 1, ms[1] + 5], rm.table.L16).reshape(2, 1, -1)
    assert torch.equal(ops.prod_rows(x, rm), x[:, 0])
    assert bi.to_ints(ops.prod_rows(x, rm))[0] > ms[0]
    pack = ops.pack_modulus(ms[0])
    assert torch.equal(ops.prod_mod(x, pack), x[:, 0])
    m8, mu8 = rops.rows_modulus(ms, L8)
    ref = rops.prod_rows(np.asarray(rops.pack_rows(
        [(1 << 128) - 1, ms[1] + 5], L8)).reshape(2, 1, L8), m8, mu8)
    assert rops.unpack_rows(ref) == bi.to_ints(x[:, 0])
    assert seen == []


def test_empty_rows():
    """R = 0 gives an empty (0, L16) tensor, under one modulus or a
    table."""
    ms = _moduli(16, 1, 9)
    pack = ops.pack_modulus(ms[0])
    x = torch.zeros((0, 5, pack.L16), dtype=torch.int32)
    rm = ops.rows_modulus(ms, 16, "cpu")
    empty = dataclasses.replace(rm, midx=rm.midx[:0])
    for out in (ops.prod_mod(x, pack), ops.prod_rows(x, empty)):
        assert out.shape == (0, pack.L16) and out.dtype == torch.int32


@pytest.mark.parametrize("bits", (64, 128))
@pytest.mark.parametrize("N", (1, 2, 5, 17))
def test_mul_tree_matches_reference(bits, N):
    """The port's one-launch ``mul_tree`` mod n^2 equals the reference's
    log-depth tree of ``ops.mulmod`` launches and ints."""
    key = rgold.keygen(bits, random.Random(bits))
    rvk = rpv.make_vec_key(key)
    vk = pv.make_vec_key(gold.keygen(bits, random.Random(bits)))
    assert vk.key.n2 == key.n2
    R, L2 = 3, vk.pack_n2.L16
    rng = random.Random(N)
    xs = [rng.getrandbits(16 * L2) for _ in range(R * N)]
    cur = bi.from_ints(xs, L2).reshape(R, N, L2)
    got = bi.to_ints(pv.mul_tree(vk, torch.as_tensor(cur)))
    ref = bi.to_ints(np.asarray(rpv.mul_tree(rvk, cur)))
    want = [x % key.n2 if N > 1 else x for x in _want(xs, N, [key.n2] * R)]
    assert got == ref == want


def test_mul_tree_matches_reference_pallas_interpret():
    """The reference tree through its Pallas ``mulmod`` kernel (interpret
    mode on the CPU) gives the port's product."""
    key = rgold.keygen(64, random.Random(3))
    vk = pv.make_vec_key(gold.keygen(64, random.Random(3)))
    R, N, L2 = 2, 5, vk.pack_n2.L16
    rng = random.Random(11)
    cur = bi.from_ints([rng.getrandbits(16 * L2) for _ in range(R * N)],
                       L2).reshape(R, N, L2)
    ref = rpv.mul_tree(rpv.make_vec_key(key), cur, backend="pallas")
    assert bi.to_ints(pv.mul_tree(vk, torch.as_tensor(cur))) == \
        bi.to_ints(np.asarray(ref))


def test_mul_tree_is_one_tree_and_no_mulmod(monkeypatch):
    """One plain tree (Montgomery, at the kernel's G) per ``mul_tree`` and
    no ``mulmod``: the card runs one launch where the reference runs
    ceil(log2 N)."""
    seen = _spy(monkeypatch)
    monkeypatch.setattr(ops, "mulmod", None)
    vk = pv.make_vec_key(gold.keygen(64, random.Random(4)))
    L2 = vk.pack_n2.L16
    x = torch.ones((192, 192, L2), dtype=torch.int32)
    ones = sum(1 << (16 * i) for i in range(L2))
    assert bi.to_ints(pv.mul_tree(vk, x)) == [pow(ones, 192, vk.key.n2)] * 192
    g = geometry.tree_geometry("prod_rows[montgomery]", 192, 192,
                               vk.pack_n2.L32)
    assert seen == [("montgomery", g.groups)]


def test_even_modulus_takes_barrett(monkeypatch):
    """A table with an even modulus has no Montgomery material: the
    Barrett body, equal to the reference and ints."""
    seen = _spy(monkeypatch)
    L8, N = 17, 6
    ms = _moduli(L8, 2, 21) + _moduli(L8, 1, 22, odd=False)
    per_row = [ms[i % 3] for i in range(6)]
    rm = ops.rows_modulus(per_row, L8, "cpu")
    assert not rm.montgomery
    rng = random.Random(23)
    xs = _factors(rng, 6, N, 8 * L8)
    got = bi.to_ints(ops.prod_rows(
        _limbs(xs, rm.table.L16).reshape(6, N, -1), rm))
    m8, mu8 = rops.rows_modulus(per_row, L8)
    ref = rops.unpack_rows(rops.prod_rows(
        np.asarray(rops.pack_rows(xs, L8)).reshape(6, N, L8), m8, mu8))
    assert got == ref == _want(xs, N, per_row)
    pack = ops.pack_modulus(ms[2])             # one even modulus
    x = _limbs(xs, pack.L16).reshape(6, N, -1)
    assert bi.to_ints(ops.prod_mod(x, pack)) == _want(xs, N, [ms[2]] * 6)
    assert [impl for impl, _ in seen] == ["barrett", "barrett"]


def test_reduce_impl_knob_leaves_the_tree_montgomery(monkeypatch):
    """The body follows the moduli alone: ``REPRO_REDUCE_IMPL=barrett``
    keeps odd moduli on the Montgomery body, as exact as the default."""
    seen = _spy(monkeypatch)
    L8, N, R = 32, 9, 4
    ms = _moduli(L8, 2, 31)
    per_row = [ms[i % 2] for i in range(R)]
    rm = ops.rows_modulus(per_row, L8, "cpu")
    rng = random.Random(32)
    xs = _factors(rng, R, N, 8 * L8)
    x = _limbs(xs, rm.table.L16).reshape(R, N, -1)
    want = _want(xs, N, per_row)
    assert bi.to_ints(ops.prod_rows(x, rm)) == want
    monkeypatch.setenv("REPRO_REDUCE_IMPL", "barrett")
    assert bi.to_ints(ops.prod_rows(x, rm)) == want
    pack = ops.pack_modulus(ms[0])
    assert bi.to_ints(ops.prod_mod(x[:1], pack)) == want[:1]
    assert [impl for impl, _ in seen] == ["montgomery"] * 3


def test_correction_is_cached_by_table_and_n():
    """R^N mod m a table modulus, computed once per (table, N, device)."""
    ms = tuple(_moduli(32, 3, 41))
    L32 = 8
    a = ops._tree_correction(ms, L32, 192, "cpu")
    assert ops._tree_correction(ms, L32, 192, "cpu") is a
    b = ops._tree_correction(ms, L32, 17, "cpu")
    assert b is not a and a.shape == b.shape == (3, 2 * L32)
    R = 1 << (32 * L32)
    assert bi.to_ints(a) == [pow(R, 192, m) for m in ms]
    assert bi.to_ints(b) == [pow(R, 17, m) for m in ms]
    assert a.dtype == torch.int32 and a.is_contiguous()


@pytest.mark.parametrize("R, N, k, want", [
    # (tpi, words, groups a row, threads a block, blocks, shared bytes)
    (2304, 192, 128, (16, 8, 16, 256, 2304, 8192)),    # S1's matvec
    (192, 192, 128, (16, 8, 16, 256, 192, 8192)),      # the main path's
    (576, 192, 128, (16, 8, 16, 256, 576, 8192)),      # the runtime's
    (192, 3, 128, (16, 8, 2, 64, 96, 2048)),           # two rows a block
    (5, 1, 8, (16, 1, 1, 64, 2, 0)),                   # no tree: G = 1
])
def test_tree_geometry_defaults(R, N, k, want):
    for body in geometry.TREE_BODIES:
        g = geometry.tree_geometry(body, R, N, k)
        assert (g.tpi, g.words, g.groups, g.threads, g.blocks, g.smem) == \
            want
        assert g.groups <= max(1, N) and g.threads % 32 == 0
        rows = g.threads // (g.tpi * g.groups)
        assert g.blocks * rows >= R > (g.blocks - 1) * rows


@pytest.mark.parametrize("body", geometry.TREE_BODIES)
@pytest.mark.parametrize("tpi", (8, 16, 32))
def test_tree_geometry_sweep_candidates(body, tpi):
    """Every (TPI, G, threads) the sweep times at n^2 is instantiated and
    fits a block."""
    cap = geometry.TREE_MAX_THREADS[tpi]
    for G in (1, 2, 4, 8, 16, 32, 64):
        if tpi * G > cap:
            continue
        for threads in {max(tpi * G, 64), min(cap, max(tpi * G, 128))}:
            g = geometry.tree_geometry(body, 2304, 192, 128, tpi, G, threads)
            assert g.tpi * g.words == 128 and g.groups == G
            assert g.threads == threads
            assert g.smem == (threads * g.words * 4 if G > 1 else 0)


@pytest.mark.parametrize("R, N, k, kwargs, match", [
    (10, 10, 128, dict(groups=3), "power of two"),
    (10, 10, 128, dict(groups=32, tpi=32), "threads per block"),
    (10, 10, 128, dict(threads=48), "threads per block"),
    (10, 10, 64, dict(tpi=8), "no instantiation"),
    (10, 0, 128, {}, "factors"),
])
def test_tree_geometry_rejects(R, N, k, kwargs, match):
    with pytest.raises(ValueError, match=match):
        geometry.tree_geometry("prod_rows[montgomery]", R, N, k, **kwargs)
    with pytest.raises(ValueError, match="tree_geometry"):
        geometry.launch_geometry("prod_rows[barrett]", R, k)


def test_operands_are_checked_and_cpu_launches_nothing():
    ms = _moduli(16, 2, 51)
    rm = ops.rows_modulus(ms + ms, 16, "cpu")
    L16 = rm.table.L16
    x = torch.ones((4, 3, L16), dtype=torch.int32)
    for bad in (x[:3], x[:, :0], torch.ones((4, 3, L16 + 1),
                                             dtype=torch.int32), x[0]):
        with pytest.raises(ValueError, match="prod_rows"):
            ops.prod_rows(bad, rm)
    with pytest.raises(ValueError, match="power of two"):
        prodtree.prod_rows_plain(x, rm.table, rm.midx, "barrett", 3)
    before = dict(build.LAUNCHES)
    ops.prod_rows(x, rm)
    ops.prod_mod(x, ops.pack_modulus(ms[0]))
    assert build.LAUNCHES == before
