"""repro_torch limb kernels (plain versions) vs the JAX reference and ints.

On the CPU the port's ``ops.mulmod`` / ``ops.modexp`` / ``ops.modexp_fixed``
run their kernels' plain PyTorch versions.  They must equal the
reference's ``repro.kernels.ops`` (``backend="ref"``, one small case
through the interpreted Pallas kernels) array for array, and Python's
``%``/``pow``, over 128-1024-bit moduli (top-limb edge moduli and an even
modulus, which falls back to Barrett), batch sizes {0, 1, 5, 130},
exponent 0, all four modexp bodies (selected through the two
environment knobs in both packages at once) and both modexp_fixed
bodies.  Tolerance: none — these are exact integer computations.

Also pinned: ``pack_modulus`` material equals the reference's, the
error cases match, and on an odd-byte modulus with full-width operands
the port equals Python ints (the reference cuts such operands to the
modulus' byte length, ``repro/kernels/ops.py:126-130``, and answers
wrongly there).
"""
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bigint as rbi
from repro.kernels import ops as rops
from repro_torch.convert import limbs_from_numpy
from repro_torch.core import bigint as bi
from repro_torch.kernels import build, geometry, ops, ref
from repro_torch.kernels import limb_mulmod as lm
from repro_torch.kernels import modexp as mx

# small tensors: one intra-op thread avoids oversubscribing the cores that
# the suite's parallel workers share
torch.set_num_threads(1)

BITS = (128, 256, 512, 1024)
IMPLS = ("montgomery", "barrett")
METHODS = ("win4", "binary")


def _moduli(bits: int) -> dict:
    """All-ones and minimal-top-limb edge moduli, a random odd and a
    random even modulus of exactly ``bits`` bits."""
    rng = random.Random(bits)
    rand = rng.getrandbits(bits) | (1 << (bits - 1))
    return {"ones": (1 << bits) - 1, "min_top": (1 << (bits - 1)) | 1,
            "odd": rand | 1, "even": rand & ~1}


def _rows(rng, B, L):
    """Full-width operands (any value below 2^{16 L}, not reduced)."""
    ints = [rng.getrandbits(16 * L) for _ in range(B)]
    return ints, rbi.from_ints(ints, L)


def _port(arr):
    return limbs_from_numpy(arr, "cpu")


def _knobs(monkeypatch, impl, method):
    """Set REPRO_REDUCE_IMPL (read per call) and the value
    REPRO_MODEXP_METHOD gives both packages' ops at import."""
    monkeypatch.setenv("REPRO_REDUCE_IMPL", impl)
    monkeypatch.setattr(rops, "MODEXP_METHOD", method)
    monkeypatch.setattr(ops, "MODEXP_METHOD", method)


@pytest.mark.parametrize("bits", BITS)
def test_pack_modulus_matches_reference(bits):
    for m in list(_moduli(bits).values()) + [(1 << 23) + 9]:
        mine, ref = ops.pack_modulus(m), rops.pack_modulus(m)
        assert (mine.m_int, mine.L16, mine.L8, mine.mp8) == \
            (ref.m_int, ref.L16, ref.L8, ref.mp8)
        for f in ("m16", "mu16", "m8", "mu8", "r1_8", "r2_8"):
            a, b = getattr(mine, f), getattr(ref, f)
            assert (a is None and b is None) or np.array_equal(a, b), (m, f)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("B", (0, 1, 5, 130))
def test_mulmod_equals_python_ints(bits, B):
    for name, m in _moduli(bits).items():
        pack = ops.pack_modulus(m)
        rng = random.Random(bits * 1000 + B)
        a, a16 = _rows(rng, B, pack.L16)
        b, b16 = _rows(rng, B, pack.L16)
        out = ops.mulmod(_port(a16), _port(b16), pack, device="cpu")
        assert out.shape == (B, pack.L16) and out.dtype == torch.int32
        assert bi.to_ints(out) == [(x * y) % m for x, y in zip(a, b)], name


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("method", METHODS)
def test_modexp_equals_python_pow(monkeypatch, bits, impl, method):
    _knobs(monkeypatch, impl, method)
    for name, m in _moduli(bits).items():
        pack = ops.pack_modulus(m)
        rng = random.Random(bits)
        base, b16 = _rows(rng, 5, pack.L16)
        exps, e16 = _rows(rng, 5, 2)
        exps[1], e16[1] = 0, 0
        out = ops.modexp(_port(b16), _port(e16), pack)
        assert bi.to_ints(out) == [pow(x, e, m) for x, e in
                                   zip(base, exps)], name


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("impl", IMPLS)
def test_modexp_fixed_equals_python_pow(monkeypatch, bits, impl):
    monkeypatch.setenv("REPRO_REDUCE_IMPL", impl)
    for name, m in _moduli(bits).items():
        pack = ops.pack_modulus(m)
        rng = random.Random(bits + 7)
        base, b16 = _rows(rng, 5, pack.L16)
        for e in (0, 1, 0x10, rng.getrandbits(min(bits, 160))):
            out = ops.modexp_fixed(_port(b16), e, pack)
            assert bi.to_ints(out) == [pow(x, e, m) for x in base], (name, e)


ALL_BODIES = (("montgomery", "win4"), ("montgomery", "binary"),
              ("barrett", "win4"), ("barrett", "binary"))


@pytest.mark.parametrize("bits, kind, bodies", [
    (128, "ones", ALL_BODIES), (1024, "odd", ALL_BODIES[:1]),
    (256, "min_top", ALL_BODIES[:1]), (512, "odd", ALL_BODIES[:1]),
    (256, "even", ALL_BODIES[2:3])])
def test_plain_versions_equal_reference_ref_backend(monkeypatch, bits, kind,
                                                    bodies):
    """Bodies selected through the env knobs, array-equal to repro's ops
    (every body at 128 bits, the defaults at the wider moduli, Barrett
    on the even modulus; the Python-int tests above cover the rest)."""
    m = _moduli(bits)[kind]
    mine, ref = ops.pack_modulus(m), rops.pack_modulus(m)
    rng = random.Random(bits ^ 0x55)
    _, a16 = _rows(rng, 5, mine.L16)
    _, b16 = _rows(rng, 5, mine.L16)
    _, e16 = _rows(rng, 5, 2)
    e16[0] = 0
    want = rops.mulmod(jnp.asarray(a16), jnp.asarray(b16), ref,
                       backend="ref")
    assert np.array_equal(ops.mulmod(_port(a16), _port(b16), mine).numpy(),
                          np.asarray(want))
    e = rng.getrandbits(min(bits, 256))
    for impl, method in bodies:
        _knobs(monkeypatch, impl, method)
        want = rops.modexp(jnp.asarray(a16), jnp.asarray(e16), ref,
                           backend="ref")
        got = ops.modexp(_port(a16), _port(e16), mine)
        assert np.array_equal(got.numpy(), np.asarray(want)), (impl, method)
        if method == "win4":          # both modexp_fixed bodies
            want = rops.modexp_fixed(jnp.asarray(a16), e, ref, backend="ref")
            got = ops.modexp_fixed(_port(a16), e, mine)
            assert np.array_equal(got.numpy(), np.asarray(want)), impl


@pytest.mark.parametrize("B", (0, 1, 130))
def test_batch_sizes_equal_reference_and_ints(B):
    """Default bodies at the batch edges: Python ints always, the
    reference's ``ref`` backend at B = 0 and at a batch that is no
    power of two (B = 130)."""
    m = _moduli(128)["odd"]
    mine, ref = ops.pack_modulus(m), rops.pack_modulus(m)
    rng = random.Random(B)
    a, a16 = _rows(rng, B, mine.L16)
    e, e16 = _rows(rng, B, 1)
    got = (ops.mulmod(_port(a16), _port(a16), mine),
           ops.modexp(_port(a16), _port(e16), mine),
           ops.modexp_fixed(_port(a16), m - 2, mine))
    assert [bi.to_ints(g) for g in got] == [
        [x * x % m for x in a], [pow(x, y, m) for x, y in zip(a, e)],
        [pow(x, m - 2, m) for x in a]]
    assert all(g.shape == (B, mine.L16) for g in got)
    if B == 1:
        return
    want = (rops.mulmod(jnp.asarray(a16), jnp.asarray(a16), ref,
                        backend="ref"),
            rops.modexp(jnp.asarray(a16), jnp.asarray(e16), ref,
                        backend="ref"),
            rops.modexp_fixed(jnp.asarray(a16), m - 2, ref, backend="ref"))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_plain_versions_equal_interpreted_pallas():
    """One small case through the reference's Pallas kernels (interpreted
    on the CPU)."""
    m = _moduli(128)["odd"]
    mine, ref = ops.pack_modulus(m), rops.pack_modulus(m)
    rng = random.Random(9)
    _, a16 = _rows(rng, 3, mine.L16)
    _, e16 = _rows(rng, 3, 1)
    want = rops.mulmod(jnp.asarray(a16), jnp.asarray(a16), ref,
                       backend="pallas")
    assert np.array_equal(ops.mulmod(_port(a16), _port(a16), mine).numpy(),
                          np.asarray(want))
    want = rops.modexp(jnp.asarray(a16), jnp.asarray(e16), ref,
                       backend="pallas")
    assert np.array_equal(ops.modexp(_port(a16), _port(e16), mine).numpy(),
                          np.asarray(want))


def test_odd_byte_modulus_full_width_operands_equal_python_ints():
    """m = 2^23 + 9 has 3 bytes (L16 = 2): a full-width 32-bit operand
    keeps its top byte in the port (the reference's mulmod returns 12345
    here, having cut a to 3 bytes)."""
    m = (1 << 23) + 9
    a = (1 << 31) + 12345
    pack = ops.pack_modulus(m)
    out = ops.mulmod(_port(rbi.from_ints([a], 2)), _port(rbi.from_ints([1], 2)),
                     pack)
    assert bi.to_ints(out) == [a % m] == [10041]
    # the wide-input path the CRT reduction uses, on a key-like odd-byte
    # modulus (p^2 of a key whose bits are not a multiple of 16)
    rng = random.Random(23)
    m = (rng.getrandbits(100) | (1 << 99) | 1) ** 2          # 199-200 bits
    pack = ops.pack_modulus(m)
    assert pack.L8 % 2 == 1
    xs, x16 = _rows(rng, 7, pack.L16)
    out = ops.mulmod(_port(x16), _port(rbi.from_ints([1] * 7, pack.L16)),
                     pack)
    assert bi.to_ints(out) == [x % m for x in xs]
    e = rng.getrandbits(64)
    assert bi.to_ints(ops.modexp_fixed(_port(x16), e, pack)) == \
        [pow(x, e, m) for x in xs]


def test_plain_dispatch_selects_each_body():
    """``kernels.ref`` names each body's plain version, as the reference's
    ``kernels.ref`` names its jnp oracle."""
    m = _moduli(256)["odd"]
    pack = ops.pack_modulus(m)
    dm = pack.on("cpu")
    rng = random.Random(4)
    base, b16 = _rows(rng, 3, pack.L16)
    exps, e16 = _rows(rng, 3, 1)
    want = [pow(x, e, m) for x, e in zip(base, exps)]
    for impl in IMPLS:
        for method in METHODS:
            out = ref.modexp_ref(_port(b16), _port(e16), dm, method, impl)
            assert bi.to_ints(out) == want, (impl, method)
    assert bi.to_ints(ref.mulmod_ref(_port(b16), _port(b16), dm)) == \
        [x * x % m for x in base]
    with pytest.raises(ValueError):
        ref.modexp_ref(_port(b16), _port(e16), dm, method="ternary")
    even = ops.pack_modulus(m - 1).on("cpu")
    with pytest.raises(ValueError, match="odd"):
        ref.modexp_ref(_port(b16), _port(e16), even, reduce_impl="montgomery")


def test_error_cases_match_reference():
    m = _moduli(128)["odd"]
    mine, ref = ops.pack_modulus(m), rops.pack_modulus(m)
    a = np.zeros((2, mine.L16), np.int32)
    for bad in (dict(method="ternary"), dict(reduce_impl="redc")):
        with pytest.raises(ValueError):
            rops.modexp(jnp.asarray(a), jnp.asarray(a), ref, **bad)
        with pytest.raises(ValueError):
            ops.modexp(_port(a), _port(a), mine, **bad)
    with pytest.raises(ValueError, match="non-negative"):
        rops.modexp_fixed(jnp.asarray(a), -1, ref)
    with pytest.raises(ValueError, match="non-negative"):
        ops.modexp_fixed(_port(a), -1, mine)
    with pytest.raises(ValueError, match="multiple of 4"):
        rops._validate_method("win4", 6)
    with pytest.raises(ValueError, match="multiple of 4"):
        ops._validate_method("win4", 6)
    with pytest.raises(ValueError, match="never cut"):
        ops.mulmod(_port(np.zeros((2, mine.L16 + 1), np.int32)), _port(a),
                   mine)


def test_cpu_tensors_take_the_plain_version_and_cuda_raises_without_card():
    m = _moduli(128)["odd"]
    pack = ops.pack_modulus(m)
    a = np.ones((4, pack.L16), np.int32)
    before = dict(build.LAUNCHES)
    ops.mulmod(_port(a), _port(a), pack)
    ops.modexp(_port(a), _port(a[:, :1]), pack)
    ops.modexp_fixed(_port(a), 65537, pack)
    assert build.LAUNCHES == before            # no kernel on CPU tensors
    # the kernel entry points take CUDA tensors only: no silent fallback
    dm = pack.on("cpu")
    with pytest.raises(ValueError, match="CUDA tensor"):
        lm.mulmod_cuda(_port(a), _port(a), dm)
    with pytest.raises(ValueError, match="CUDA tensor"):
        mx.modexp_cuda(_port(a), _port(a[:, :1]), dm, "win4", "montgomery")
    with pytest.raises(ValueError, match="CUDA tensor"):
        mx.modexp_fixed_cuda(_port(a), (1, 2), dm, "montgomery")
    with pytest.raises(ValueError, match="CUDA tensor"):
        mx.modexp_fixed_pair_cuda((_port(a), _port(a)), ((1, 2), (3,)),
                                  (dm, dm))
    with pytest.raises(ValueError, match="one width"):
        mx.modexp_fixed_pair_cuda(
            (_port(a), _port(a)), ((1, 2), (3,)),
            (dm, ops.pack_modulus(_moduli(256)["odd"]).on("cpu")))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ops.mulmod(a, a, pack)             # numpy input defaults to cuda


@pytest.mark.parametrize("impl", IMPLS)
def test_leading_zero_windows_leave_the_fixed_ladder_unchanged(impl):
    """The two-half launch pads the shorter schedule in front with zero
    windows: 1^16 * table[0] = 1, so the result must not move."""
    m = _moduli(256)["odd"]
    pack = ops.pack_modulus(m)
    dm = pack.on("cpu")
    rng = random.Random(11)
    base, b16 = _rows(rng, 5, pack.L16)
    e = rng.getrandbits(200)
    win = ops.mg.exp_windows(e)
    padded = mx.modexp_fixed_plain(_port(b16), (0, 0, 0) + win, dm, impl)
    assert torch.equal(padded, mx.modexp_fixed_plain(_port(b16), win, dm,
                                                     impl))
    assert bi.to_ints(padded) == [pow(x, e, m) for x in base]


@pytest.mark.parametrize("Bp, Bq", [(0, 0), (0, 3), (5, 2)])
def test_modexp_fixed_pair_equals_two_singles(Bp, Bq):
    """Both CRT halves in one call, exponents of different lengths and 0,
    equal one modexp_fixed per half (on the CPU: their plain versions)."""
    p2, q2 = _moduli(512)["odd"], _moduli(512)["ones"]
    packs = (ops.pack_modulus(p2), ops.pack_modulus(q2))
    rng = random.Random(Bp * 7 + Bq)
    (bp, bp16), (bq, bq16) = _rows(rng, Bp, packs[0].L16), \
        _rows(rng, Bq, packs[1].L16)
    for exps in ((rng.getrandbits(500), rng.getrandbits(90)), (0, 65537)):
        xp, xq = ops.modexp_fixed_pair((_port(bp16), _port(bq16)), exps,
                                       packs)
        assert bi.to_ints(xp) == [pow(x, exps[0], p2) for x in bp]
        assert bi.to_ints(xq) == [pow(x, exps[1], q2) for x in bq]
        assert torch.equal(xp, ops.modexp_fixed(_port(bp16), exps[0],
                                                packs[0]))
    with pytest.raises(ValueError, match="non-negative"):
        ops.modexp_fixed_pair((_port(bp16), _port(bq16)), (-1, 3), packs)


# ---------------------------------------------------------------------------
# launch geometry (computed on the host, passed to every C launcher)
# ---------------------------------------------------------------------------

# the main path's batches: 0 and 1, Nk = 192 (one encryption's half), 384
# (N = 1,152), the product tree's top level Nk^2/2 and an edge's matvec Nk^2
MAIN_BATCHES = (0, 1, 192, 384, 18_432, 36_864)


# the bodies launch_geometry sizes (the product tree's: tree_geometry,
# tests/test_torch_prod_tree.py)
ELEMENT_BODIES = tuple(b for b in geometry.BODIES
                       if b not in geometry.TREE_BODIES)


@pytest.mark.parametrize("body", ELEMENT_BODIES)
def test_launch_geometry_covers_every_width(body):
    """For every width 1..MAX_WORDS and main-path batch: an instantiated
    shape that holds k words, whole warps, blocks that cover B exactly
    once, and shared memory and threads within Hopper's per-block limits.
    Every body runs a group of threads per integer; every win4 and fixed
    ladder keeps a 16-entry table."""
    kernel = body.split("[")[0]
    table = kernel == "modexp_fixed" or body.endswith(",win4]")
    for k in range(1, geometry.MAX_WORDS + 1):
        for B in MAIN_BATCHES:
            g = geometry.launch_geometry(body, B, k)
            assert g.threads % 32 == 0 and g.threads <= geometry.MAX_THREADS
            assert g.smem <= geometry.MAX_SMEM_BYTES
            assert g.blocks * g.per_block >= B > (g.blocks - 1) * g.per_block
            assert g.tpi == geometry.group_size(body, B, k)
            if kernel in ("mulmod", "mulmod_rows") \
                    and B >= geometry.MULMOD_FULL_BATCH:
                # the fewest threads (at least 8) that hold k words at 8
                # words per lane
                assert g.words <= 8 and (g.tpi == 8 or
                                         g.tpi * 8 >= k > g.tpi * 4)
            else:
                assert g.tpi == geometry.TPI[body]
            assert g.threads == geometry.BLOCK_THREADS[kernel]
            assert (g.tpi, g.words) in geometry.SHAPES[body]
            assert g.tpi * g.words >= k > g.tpi * g.words // 2 or \
                g.words == 1
            assert g.smem == (16 * g.words * g.threads * 4 if table else 0)


@pytest.mark.parametrize("body, B, k, want", [
    # a warp per p^2 residue in its own block, both fixed bodies
    ("modexp_fixed[montgomery]", 192, 64, (32, 2, 1, 192, 4096)),
    ("modexp_fixed[barrett]", 192, 64, (32, 2, 1, 192, 4096)),
    # eight threads per residue for an edge's matvec, sixteen for the
    # Barrett win4 body of the Barrett arm (REPRO_REDUCE_IMPL=barrett)
    ("modexp[montgomery,win4]", 36_864, 64, (8, 8, 8, 4608, 32768)),
    ("modexp[barrett,win4]", 36_864, 64, (16, 4, 4, 9216, 16384)),
    # mulmod: the sum, blinding and CRT multiplies, the tree's top level
    # on n^2 and the reductions of an edge's matvec into p^2
    ("mulmod", 192, 64, (32, 2, 2, 96, 0)),
    ("mulmod", 192, 128, (32, 4, 2, 96, 0)),
    ("mulmod", 18_432, 128, (16, 8, 4, 4608, 0)),
    ("mulmod", 36_864, 64, (8, 8, 8, 4608, 0)),
    # the serving path's per-row bodies at n^2: four tenants' fused
    # matvec and round encryptions, the product tree's top level and a
    # round's sums
    ("modexp_rows[barrett,win4]", 442_368, 128, (16, 8, 4, 110_592, 32768)),
    ("modexp_rows[barrett,win4]", 4_608, 128, (16, 8, 4, 1152, 32768)),
    ("modexp_rows[barrett,binary]", 4_608, 128, (8, 16, 8, 576, 0)),
    # the Montgomery per-row bodies (the default reduction): the fused
    # matvec, the round encryptions and decryptions
    ("modexp_rows[montgomery,win4]", 442_368, 128,
     (16, 8, 4, 110_592, 32768)),
    ("modexp_rows[montgomery,win4]", 4_608, 128, (16, 8, 4, 1152, 32768)),
    ("modexp_rows[montgomery,win4]", 2_304, 128, (16, 8, 4, 576, 32768)),
    ("modexp_rows[montgomery,win4]", 4_608, 64, (16, 4, 4, 1152, 16384)),
    ("modexp_rows[montgomery,binary]", 4_608, 128, (16, 8, 4, 1152, 0)),
    ("mulmod_rows[montgomery]", 221_184, 128, (16, 8, 4, 55_296, 0)),
    ("mulmod_rows[montgomery]", 2_304, 128, (32, 4, 2, 1152, 0)),
    ("mulmod_rows[barrett]", 221_184, 128, (16, 8, 4, 55_296, 0)),
    ("mulmod_rows[barrett]", 2_304, 128, (32, 4, 2, 1152, 0)),
])
def test_launch_geometry_main_path_shapes(body, B, k, want):
    """The main path's launches, one case per launch shape."""
    g = geometry.launch_geometry(body, B, k)
    assert (g.tpi, g.words, g.per_block, g.blocks, g.smem) == want


@pytest.mark.parametrize("body, tpi", [
    (body, tpi) for body in ELEMENT_BODIES
    for tpi in sorted({t for t, _ in geometry.SHAPES[body]})])
def test_launch_geometry_group_size_candidates(body, tpi):
    """Every group size timed against the chosen one holds 64 words (the
    per-row Montgomery bodies': 128, the width of their sweep)."""
    k = 128 if body.startswith("modexp_rows[montgomery") else 64
    g = geometry.launch_geometry(body, 192, k, tpi=tpi)
    assert g.tpi == tpi and tpi * g.words == k


@pytest.mark.parametrize("body, tpi, threads", [
    (body, tpi, threads)
    for body in ("modexp_rows[montgomery,win4]",
                 "modexp_rows[montgomery,binary]")
    for tpi in sorted({t for t, _ in geometry.SHAPES[body]})
    for threads in geometry.SWEEP_THREADS])
def test_launch_geometry_sweep_block_sizes(body, tpi, threads):
    """The sweep's candidates at n^2: each group size in 64- and
    128-thread blocks, the win4 table growing with the block."""
    g = geometry.launch_geometry(body, 4_608, 128, tpi=tpi, threads=threads)
    assert (g.tpi, g.threads, g.per_block) == (tpi, threads,
                                                threads // tpi)
    assert g.blocks == -(-4_608 // g.per_block)
    assert g.smem == (16 * 128 * 4 * g.per_block if body.endswith("win4]")
                      else 0)


def test_launch_geometry_rejects_partial_warps():
    with pytest.raises(ValueError, match="whole number of warps"):
        geometry.launch_geometry("modexp_rows[montgomery,win4]", 192, 128,
                                 threads=48)


@pytest.mark.parametrize("tpi", sorted({t for t, _ in
                                        geometry.SHAPES["mulmod"]}))
def test_mulmod_candidates_cover_every_width(tpi):
    """Every mulmod group size is instantiated at every width, so the
    group size can be chosen by batch alone."""
    for k in range(1, geometry.MAX_WORDS + 1):
        g = geometry.launch_geometry("mulmod", 192, k, tpi=tpi)
        assert (tpi, g.words) in geometry.SHAPES["mulmod"]
        assert g.tpi * g.words >= k


@pytest.mark.parametrize("body, B, k, tpi, match", [
    ("modexp_fixed[montgomery]", 5, 0, None, "outside"),
    ("modexp_fixed[montgomery]", 5, geometry.MAX_WORDS + 1, None, "outside"),
    ("mulmod", 5, 0, None, "outside"),
    ("modexp[montgomery,win4]", -1, 64, None, "negative batch"),
    ("modexp[montgomery,win4]", 5, 64, 32, "no instantiation"),
    ("modexp_fixed[montgomery]", 5, 128, 8, "no instantiation"),
    ("modexp[barrett,win4]", 5, 64, 32, "no instantiation"),
    ("mulmod", 5, 64, 4, "no instantiation"),
    ("modexp[sideways,win4]", 5, 64, None, "unknown kernel body"),
])
def test_launch_geometry_rejects(body, B, k, tpi, match):
    with pytest.raises(ValueError, match=match):
        geometry.launch_geometry(body, B, k, tpi)


@pytest.mark.parametrize("body, threads, match, fits_at_k1", [
    ("modexp[montgomery,win4]", 1024, "shared memory", True),
    ("modexp_fixed[montgomery]", 2048, "threads per block", False),
])
def test_launch_geometry_rejects_blocks_over_the_limits(
        monkeypatch, body, threads, match, fits_at_k1):
    """Wider blocks than the chosen ones: 16 entries x 16 words x 1,024
    threads x 4 bytes is 1 MB of table at 128 words (64 KB at one word);
    2,048 threads is over the limit at any width."""
    monkeypatch.setitem(geometry.BLOCK_THREADS, body.split("[")[0], threads)
    with pytest.raises(ValueError, match=match):
        geometry.launch_geometry(body, 192, geometry.MAX_WORDS)
    if fits_at_k1:
        assert geometry.launch_geometry(body, 192, 1).threads == threads
    else:
        with pytest.raises(ValueError, match=match):
            geometry.launch_geometry(body, 192, 1)


def test_body_names_are_the_launch_counter_keys():
    assert set(build.LAUNCHES) == set(geometry.BODIES)
    names = {geometry.body_name("mulmod")}
    for impl in ("montgomery", "barrett"):
        names.add(geometry.body_name("modexp_fixed", impl))
        names.add(geometry.body_name("mulmod_rows", impl))
        for method in ("win4", "binary"):
            names.add(geometry.body_name("modexp", impl, method))
    for impl in ("montgomery", "barrett"):  # the per-row bodies
        for method in ("win4", "binary"):
            names.add(geometry.body_name("modexp_rows", impl, method))
        names.add(geometry.body_name("prod_rows", impl))  # the tree
    assert names == set(geometry.BODIES)
    # every launcher is exported by one of the sources
    assert {src for src, _, _ in build.KERNELS.values()} == \
        set(build.SOURCES)


# ---------------------------------------------------------------------------
# the cooperative Barrett product's quotient estimate (limbs.cuh barrett_mul)
# ---------------------------------------------------------------------------

def _barrett_moduli(k: int) -> dict:
    """k-word moduli: top word 1 (the loosest estimate: mu's top word is
    near 2^32), all ones, top bit only plus 1, a random odd and a random
    even one (2^{32(k-1)} itself is refused by pack_modulus: its mu needs
    k+2 words)."""
    rng = random.Random(k)
    low = 1 << (32 * (k - 1))
    mods = {"ones": (1 << (32 * k)) - 1, "top_bit": (1 << (32 * k - 1)) | 1,
            "odd": rng.getrandbits(32 * k) | (1 << (32 * k - 1)) | 1}
    mods["even"] = mods["odd"] - 1
    if k > 1:
        mods["top1_min"] = low + 1
        mods["top1"] = low | rng.getrandbits(32 * (k - 1)) | 1
    return mods


def _barrett_remainder(x: int, m: int, k: int, lo_shift: int,
                       hi_shift: int) -> int:
    """x - q3 m with the kernel's estimate q3 = floor(floor(x / b^lo) mu /
    b^hi), b = 2^32, mu = floor(b^{2k} / m); the kernel takes lo = k - 1,
    hi = k + 1 and forms the difference mod b^{k+1}."""
    mu = (1 << (64 * k)) // m
    q3 = ((x >> (32 * lo_shift)) * mu) >> (32 * hi_shift)
    return x - q3 * m


@pytest.mark.parametrize("k", (1, 2, 8, 63, 64, 128))
def test_barrett_estimate_needs_at_most_two_subtractions(k):
    """With the shifts k - 1 and k + 1 and mu of k + 1 words (the width of
    ``ModulusPack.muw``, what ``group_load_mu`` reads), the remainder
    formed mod b^{k+1} is exact and below 3m for every x < 2^{64k}: the
    kernel's two masked subtractions of m make it canonical."""
    b_k1 = 1 << (32 * (k + 1))
    for name, m in _barrett_moduli(k).items():
        mu = (1 << (64 * k)) // m
        assert mu < b_k1, name
        pack = ops.pack_modulus(m)
        assert pack.L32 == k and bi.to_ints(pack.muw[None, :]) == [mu]
        rng = random.Random(k * 1009 + len(name))
        top = (1 << (64 * k)) - 1
        xs = [top, ((1 << (32 * k)) - 1) ** 2, 0, m - 1, m, 3 * m - 1,
              top - top % m, top - top % m - 1]
        xs += [rng.getrandbits(64 * k) for _ in range(300)]
        xs += [rng.getrandbits(32 * k) * m + rng.randrange(m)
               for _ in range(50)]
        for x in xs:
            x = min(x, top)
            r = _barrett_remainder(x, m, k, k - 1, k + 1)
            r1, r2 = x % b_k1, (x - r) % b_k1      # x mod b^{k+1}, q3 m
            assert (r1 - r2) % b_k1 == r, (name, x)
            assert 0 <= r < 3 * m, (name, x)
            subs = 0
            while r >= m:
                r -= m
                subs += 1
            assert subs <= 2 and r == x % m, (name, x)


@pytest.mark.parametrize("k", (2, 8, 64, 128))
def test_barrett_lane_aligned_shifts_are_not_exact(k):
    """Shifting by k on both sides (lane-aligned) loses up to b^k / m
    multiples of m: about 2^32 when m's top word is 1."""
    m = (1 << (32 * (k - 1))) + 1
    x = (1 << (64 * k)) - 1
    assert _barrett_remainder(x, m, k, k, k) // m > 1 << 31
    assert _barrett_remainder(x, m, k, k - 1, k + 1) < 3 * m


def test_mulmod_row_strides():
    """The kernel reads a and b with row strides: a column slice keeps its
    stride and storage, a broadcast row has stride 0, a transposed view is
    made contiguous."""
    x = torch.arange(24, dtype=torch.int32).reshape(4, 6)
    assert lm._row_stride(x)[1] == 6
    sl, st = lm._row_stride(x[:, 2:4])
    assert st == 6 and sl.data_ptr() == x[:, 2:4].data_ptr()
    assert lm._row_stride(x[:1].expand(4, 6))[1] == 0
    tr, st = lm._row_stride(x.t())
    assert st == 4 and torch.equal(tr, x.t())
