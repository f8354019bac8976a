"""repro_torch CUDA kernels vs their plain PyTorch versions, on the card.

Every body of the three hand-written kernels (mulmod; modexp's four
(reduction x window) bodies; modexp_fixed's two) is held against its
plain version on the same CUDA tensors and against Python ints, at small
widths including an odd-byte modulus with full-width operands, and at
ragged batch sizes.  Every body runs a group of threads per big integer,
and each is also held, with zero tolerance, at widths k = 8, 16, 32, 63,
64 and 128 words (a random odd modulus and the top-word edge 2^{32k} - 1
at each; the 1000-bit odd-byte modulus at k = 32 and a 2000-bit one at
k = 63, where k is not a multiple of the group), batches {0, 1, 77, one
more than a block's integers, 192; mulmod also the batch from which it
runs smaller groups}, and exponents 0, 1 and one whose 4-bit windows
take all 16 values.  The Barrett bodies also take an even modulus, mulmod
and modexp_fixed[barrett] a modulus whose top word is 1 (Barrett's
quotient estimate is loosest there), and mulmod the
operands 0, m - 1, m and 2^{16 L16} - 1, a broadcast b row, a column
slice and every instantiated group size at every width; the win4 bodies
of modexp and modexp_fixed every group size at k = 64.  The two-half
modexp_fixed launch (both CRT halves in one launch) is held against one
plain call per half.  Small protocol runs on the card (the gold arm, the
vec arm, the collaborative mode, a consensus family through secure
aggregation and a churned run) and small runs of the event-driven
runtime (sync gold and vec, deadline gold) are held against the same
runs on the CPU.  The serving path's per-row-modulus bodies
(``mulmod_rows`` and ``modexp_rows``, each with both reductions, and
both ladders) are held against their plain versions and Python ints at
k = 8, 32, 64 and 128 with three moduli per launch (one with a top byte
of 1, and an even one for the Barrett bodies: ``mulmod_rows`` launches
Montgomery on an all-odd table and Barrett on one with an even modulus),
ragged batches, every group and block size the sweeps time, both
``mulmod_rows`` bodies at S1's and S2's shapes, and 2,048-bit exponents
at n^2; the rows Paillier ops on the card against the CPU, and under
``torch.cuda.set_sync_debug_mode("error")`` up to their first read-back;
and a small ``ProtocolEngine`` run on the card against its tenants' solo
runs.  The product-tree kernel (both bodies) is held
against its plain version and Python ints at k = 8, 32, 64 and 128, N in
{2, 3, 17, 192}, three moduli a launch (an even one for Barrett) and one
(``ops.prod_mod``), factors up to 2^{16 L16} - 1, at every (TPI, G,
block) of its sweep at n^2, and on strided factors.  The ten reduced language models in float32 give
the same greedy tokens on the card as on the CPU, with logits within
1e-3.  These tests need an NVIDIA card and skip
without one; on the card run
``python -m pytest -m cuda tests/test_torch_cuda.py``.
"""
import random

import numpy as np
import pytest
import torch

from repro_torch import workloads
from repro_torch.core import bigint as bi
from repro_torch.core import churn
from repro_torch.core import protocol
from repro_torch.core.quantization import QuantSpec
from repro_torch.data.synthetic import make_lasso
from repro_torch.obs.metrics import report_core
from repro_torch.kernels import build, geometry, ops
from repro_torch.kernels import limb_mulmod as lm
from repro_torch.kernels import modexp as mx

pytestmark = pytest.mark.cuda

BITS = (24, 200, 1000, 2048)     # 24 and 1000 bits: odd byte lengths
BATCHES = (1, 5, 130)
MAIN_PATH_BODIES = ("mulmod", "modexp[montgomery,win4]",
                    "modexp_fixed[montgomery]", "prod_rows[montgomery]")
# cooperative bodies: width k in words -> bits of its random odd modulus
WIDTH_BITS = {8: 256, 16: 512, 32: 1000, 63: 2000, 64: 2048, 128: 4096}
ALL_WINDOWS = 0xFEDCBA9876543210          # 4-bit windows 15, 14, ..., 0


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _odd_modulus(bits: int) -> int:
    return random.Random(bits).getrandbits(bits) | (1 << (bits - 1)) | 1


def _rows(rng, B, L, dev):
    """Full-width operands: any value below 2^{16 L}, not reduced mod m."""
    ints = [rng.getrandbits(16 * L) for _ in range(B)]
    return ints, torch.as_tensor(bi.from_ints(ints, L), device=dev)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("B", BATCHES)
def test_mulmod_kernel_matches_plain_and_ints(dev, bits, B):
    m = _odd_modulus(bits)
    pack = ops.pack_modulus(m)
    dm = pack.on(dev)
    rng = random.Random(bits * 7 + B)
    a, at = _rows(rng, B, pack.L16, dev)
    b, bt = _rows(rng, B, pack.L16, dev)
    out = lm.mulmod_cuda(at, bt, dm)
    torch.cuda.synchronize()
    assert torch.equal(out, lm.mulmod_plain(at, bt, dm))
    assert bi.to_ints(out) == [(x * y) % m for x, y in zip(a, b)]


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("impl", ("montgomery", "barrett"))
@pytest.mark.parametrize("method", ("win4", "binary"))
def test_modexp_kernel_matches_plain_and_ints(dev, bits, impl, method):
    m = _odd_modulus(bits)
    pack = ops.pack_modulus(m)
    dm = pack.on(dev)
    rng = random.Random(bits)
    base, bt = _rows(rng, 5, pack.L16, dev)
    exps, et = _rows(rng, 5, 4, dev)
    exps[0] = 0
    et[0] = 0
    out = mx.modexp_cuda(bt, et, dm, method, impl)
    torch.cuda.synchronize()
    assert torch.equal(out, mx.modexp_plain(bt, et, dm, method, impl))
    assert bi.to_ints(out) == [pow(x, e, m) for x, e in zip(base, exps)]


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("impl", ("montgomery", "barrett"))
def test_modexp_fixed_kernel_matches_plain_and_ints(dev, bits, impl):
    m = _odd_modulus(bits)
    pack = ops.pack_modulus(m)
    dm = pack.on(dev)
    rng = random.Random(bits + 1)
    base, bt = _rows(rng, 5, pack.L16, dev)
    e = rng.getrandbits(bits)
    windows = ops.mg.exp_windows(e)
    out = mx.modexp_fixed_cuda(bt, windows, dm, impl)
    torch.cuda.synchronize()
    assert torch.equal(out, mx.modexp_fixed_plain(bt, windows, dm, impl))
    assert bi.to_ints(out) == [pow(x, e, m) for x in base]


def test_even_modulus_and_empty_batch_on_card(dev):
    m = _odd_modulus(300) - 1
    pack = ops.pack_modulus(m)
    rng = random.Random(3)
    base, bt = _rows(rng, 9, pack.L16, dev)
    exps, et = _rows(rng, 9, 2, dev)
    before = dict(build.LAUNCHES)
    out = ops.modexp(bt, et, pack)
    assert bi.to_ints(out) == [pow(x, e, m) for x, e in zip(base, exps)]
    assert bi.to_ints(ops.modexp_fixed(bt, 12345, pack)) == \
        [pow(x, 12345, m) for x in base]
    assert ops.mulmod(bt[:0], bt[:0], pack).shape == (0, pack.L16)
    assert bi.to_ints(ops.modexp_fixed(bt, 0, pack)) == [1] * 9
    for body, n in build.LAUNCHES.items():    # even modulus: Barrett
        assert n == before[body] + (body in ("modexp[barrett,win4]",
                                             "modexp_fixed[barrett]")), body


def test_protocol_on_card_equals_cpu_run(dev):
    """The gold-batched LASSO protocol on the card gives the CPU run's
    history bytes and RunReport core (small key), launching every kernel."""
    inst = make_lasso(24, 32, sparsity=0.1, noise=0.01, seed=1)
    cfg = protocol.ProtocolConfig(K=4, lam=0.05, iters=2, seed=0,
                                  spec=QuantSpec(1e6, -8.0, 8.0),
                                  cipher="gold", key_bits=128)
    build.reset_launches()
    on_card = protocol.run_protocol(inst.A, inst.y, cfg)
    for body in MAIN_PATH_BODIES:
        assert build.LAUNCHES[body] > 0, build.LAUNCHES
    on_cpu = protocol.run_protocol(inst.A, inst.y, cfg, device="cpu")
    assert on_card.history.tobytes() == on_cpu.history.tobytes()
    assert report_core(on_card.stats) == report_core(on_cpu.stats)
    assert np.all(np.isfinite(on_card.history))


SURFACE = {"vec": dict(cipher="vec"),
           "collaborative": dict(cipher="gold", collaborative=True),
           "consensus_lasso": dict(cipher="gold", workload="consensus_lasso",
                                   lam=0.05),
           "churn": dict(cipher="gold", iters=5, recycle=True,
                         churn=churn.ChurnSchedule.quarter(4, 5))}


@pytest.mark.parametrize("arm", SURFACE)
def test_protocol_surface_on_card_equals_cpu_run(dev, arm):
    """The vec arm, Algorithm 3, secure aggregation and churn on the
    card give the CPU runs' history bytes and RunReport cores."""
    kw = dict(K=4, lam=0.05, iters=2, seed=0, key_bits=128,
              spec=QuantSpec(1e6, -8.0, 8.0))
    kw.update(SURFACE[arm])
    inst = make_lasso(24, 32, sparsity=0.1, noise=0.01, seed=1)
    wl = None
    if arm == "consensus_lasso":
        wl = workloads.get_default(arm)
        inst = wl.make_instance(24, 8, 4, seed=1)
        kw["spec"] = wl.calibrate_spec(inst.A, inst.y, 4, kw["iters"])
    cfg = protocol.ProtocolConfig(**kw)
    build.reset_launches()
    on_card = protocol.run_protocol(inst.A, inst.y, cfg, workload=wl)
    for body in MAIN_PATH_BODIES:
        assert build.LAUNCHES[body] > 0, build.LAUNCHES
    on_cpu = protocol.run_protocol(inst.A, inst.y, cfg, workload=wl,
                                   device="cpu")
    assert on_card.history.tobytes() == on_cpu.history.tobytes()
    assert report_core(on_card.stats) == report_core(on_cpu.stats)


RUNTIME = {"gold_sync": dict(cipher="gold"),
           "vec_sync": dict(cipher="vec"),
           "gold_deadline": dict(cipher="gold", iters=4, deadline=0.2,
                                 latency_fn=lambda k, t: 0.5 if k == 1
                                 else 0.05)}


@pytest.mark.parametrize("arm", RUNTIME)
def test_runtime_on_card_equals_cpu_run(dev, arm):
    """The event-driven runtime on the card (the K edges' matvecs fused
    into one launch; a deadline run with a straggler behind a slow link
    and held ops) gives the CPU run's history, stale events, RunReport
    core and virtual clock."""
    from repro_torch.runtime import LinkModel, runner
    kw = dict(K=4, lam=0.05, iters=2, seed=0, key_bits=128,
              spec=QuantSpec(1e6, -8.0, 8.0))
    kw.update(RUNTIME[arm])
    inst = make_lasso(24, 32, sparsity=0.1, noise=0.01, seed=1)
    cfg = protocol.ProtocolConfig(**kw)
    run_kw = dict(per_link={("master", "edge1"): LinkModel(latency_s=0.15)},
                  coalesce_hold_ticks="auto", tick_s=1e-3) \
        if cfg.deadline else {}
    build.reset_launches()
    on_card = runner.run_on_runtime(inst.A, inst.y, cfg, **run_kw)
    for body in MAIN_PATH_BODIES:
        assert build.LAUNCHES[body] > 0, build.LAUNCHES
    on_cpu = runner.run_on_runtime(inst.A, inst.y, cfg, device="cpu",
                                   **run_kw)
    assert on_card.history.tobytes() == on_cpu.history.tobytes()
    assert on_card.stale_events == on_cpu.stale_events
    assert report_core(on_card.stats) == report_core(on_cpu.stats)
    for key in ("iter_times", "launches", "coalesced_ops", "held_flushes"):
        assert on_card.stats["runtime"][key] == on_cpu.stats["runtime"][key]


def _width_modulus(k: int, kind: str) -> int:
    if kind == "edge":                    # top word all ones: 2^{32k} - 1
        return (1 << (32 * k)) - 1
    if kind == "top1":                    # top word 1, odd limb count
        low = random.Random(k).getrandbits(32 * (k - 1))
        return (1 << (32 * (k - 1))) | low | 1
    if kind == "even":
        return _odd_modulus(WIDTH_BITS[k]) - 1
    return _odd_modulus(WIDTH_BITS[k])


def _cooperative_batches(body: str) -> tuple:
    per_block = geometry.BLOCK_THREADS[body.split("[")[0]] \
        // geometry.TPI[body]
    return (0, 1, 77, per_block + 1, 192)


@pytest.mark.parametrize("k", sorted(WIDTH_BITS))
@pytest.mark.parametrize("impl, kind, method, B", [
    (impl, kind, method, B)
    for impl, kinds in (("montgomery", ("random", "edge")),
                        ("barrett", ("random", "edge", "even")))
    for kind in kinds for method in ("win4", "binary")
    for B in _cooperative_batches(geometry.body_name("modexp", impl,
                                                     method))])
def test_cooperative_modexp_matches_plain_and_ints(dev, k, impl, kind, B,
                                                   method):
    m = _width_modulus(k, kind)
    pack = ops.pack_modulus(m)
    assert pack.L32 == k
    dm = pack.on(dev)
    rng = random.Random(k * 31 + B)
    base, bt = _rows(rng, B, pack.L16, dev)
    exps, et = _rows(rng, B, 4, dev)
    for i, e in enumerate((0, 1, ALL_WINDOWS)[:B]):
        exps[i] = e
        et[i] = torch.as_tensor(bi.from_ints([e], 4)[0], device=dev)
    body = geometry.body_name("modexp", impl, method)
    before = build.LAUNCHES[body]
    out = mx.modexp_cuda(bt, et, dm, method, impl)
    torch.cuda.synchronize()
    assert build.LAUNCHES[body] == before + (B > 0)
    assert torch.equal(out, mx.modexp_plain(bt, et, dm, method, impl))
    assert bi.to_ints(out) == [pow(x, e, m) for x, e in zip(base, exps)]


@pytest.mark.parametrize("k", sorted(WIDTH_BITS))
@pytest.mark.parametrize("kind", ("random", "edge"))
@pytest.mark.parametrize("B",
                         _cooperative_batches("modexp_fixed[montgomery]"))
def test_cooperative_modexp_fixed_matches_plain_and_ints(dev, k, kind, B):
    m = _width_modulus(k, kind)
    pack = ops.pack_modulus(m)
    assert pack.L32 == k
    dm = pack.on(dev)
    rng = random.Random(k * 37 + B)
    base, bt = _rows(rng, B, pack.L16, dev)
    for e in (1, ALL_WINDOWS, rng.getrandbits(128)):
        windows = ops.mg.exp_windows(e)
        out = mx.modexp_fixed_cuda(bt, windows, dm, "montgomery")
        torch.cuda.synchronize()
        assert torch.equal(out, mx.modexp_fixed_plain(bt, windows, dm,
                                                      "montgomery")), e
        assert bi.to_ints(out) == [pow(x, e, m) for x in base], e
    # e = 0 is answered without a launch
    before = build.LAUNCHES["modexp_fixed[montgomery]"]
    assert bi.to_ints(ops.modexp_fixed(bt, 0, pack)) == [1] * B
    assert build.LAUNCHES["modexp_fixed[montgomery]"] == before


@pytest.mark.parametrize("body, tpi", [
    (body, tpi) for body in ("modexp[montgomery,win4]",
                             "modexp[barrett,win4]",
                             "modexp_fixed[montgomery]")
    for tpi in sorted({t for t, _ in geometry.SHAPES[body]})])
def test_every_group_size_matches_plain_at_main_width(dev, body, tpi):
    """The group sizes timed against the chosen one, at k = 64."""
    m = _odd_modulus(2048)
    pack = ops.pack_modulus(m)
    dm = pack.on(dev)
    rng = random.Random(tpi)
    base, bt = _rows(rng, 77, pack.L16, dev)
    if body.startswith("modexp["):
        impl = body[len("modexp["):].split(",")[0]
        exps, et = _rows(rng, 77, 4, dev)
        out = mx.modexp_cuda(bt, et, dm, "win4", impl, tpi=tpi)
        want = [pow(x, e, m) for x, e in zip(base, exps)]
        plain = mx.modexp_plain(bt, et, dm, "win4", impl)
    else:
        e = rng.getrandbits(2048)
        windows = ops.mg.exp_windows(e)
        out = mx.modexp_fixed_cuda(bt, windows, dm, "montgomery", tpi=tpi)
        want = [pow(x, e, m) for x in base]
        plain = mx.modexp_fixed_plain(bt, windows, dm, "montgomery")
    torch.cuda.synchronize()
    assert torch.equal(out, plain)
    assert bi.to_ints(out) == want


@pytest.mark.parametrize("k, tpi", [(8, None), (63, None), (64, None),
                                    (128, None), (63, 8), (64, 8)])
@pytest.mark.parametrize("Bp, Bq", [(0, 77), (1, 1), (77, 5), (192, 192)])
def test_modexp_fixed_pair_matches_plain_per_half(dev, k, Bp, Bq, tpi):
    """One launch for both halves: a random odd and the edge modulus of
    one width, exponents of different lengths (the shorter schedule is
    padded), and with 8 threads per integer a warp that straddles the two
    halves."""
    moduli = (_width_modulus(k, "random") if k != 63
              else _odd_modulus(32 * 63), _width_modulus(k, "edge"))
    packs = [ops.pack_modulus(m) for m in moduli]
    dms = tuple(p.on(dev) for p in packs)
    rng = random.Random(k + 3 * Bp + Bq)
    (bp, bpt), (bq, bqt) = _rows(rng, Bp, packs[0].L16, dev), \
        _rows(rng, Bq, packs[1].L16, dev)
    exps = (rng.getrandbits(128), ALL_WINDOWS)
    windows = tuple(ops.mg.exp_windows(e) for e in exps)
    before = build.LAUNCHES["modexp_fixed[montgomery]"]
    xp, xq = mx.modexp_fixed_pair_cuda((bpt, bqt), windows, dms, tpi)
    torch.cuda.synchronize()
    assert build.LAUNCHES["modexp_fixed[montgomery]"] == before + 1
    assert torch.equal(xp, mx.modexp_fixed_plain(bpt, windows[0], dms[0],
                                                 "montgomery"))
    assert torch.equal(xq, mx.modexp_fixed_plain(bqt, windows[1], dms[1],
                                                 "montgomery"))
    assert bi.to_ints(xp) == [pow(x, exps[0], moduli[0]) for x in bp]
    assert bi.to_ints(xq) == [pow(x, exps[1], moduli[1]) for x in bq]


BARRETT_KINDS = ("random", "edge", "top1", "even")


def _mulmod_operands(rng, B, pack, dev):
    """Full-width rows whose first rows are the edge operands: 0, m - 1,
    m and 2^{16 L16} - 1 against 2^{16 L16} - 1, m - 1 and 1."""
    m, full = pack.m_int, (1 << (16 * pack.L16)) - 1
    a = [rng.getrandbits(16 * pack.L16) for _ in range(B)]
    b = [rng.getrandbits(16 * pack.L16) for _ in range(B)]
    for i, (x, y) in enumerate(((full, full), (0, full), (m - 1, m - 1),
                                (m, 1), (m, full))[:B]):
        a[i], b[i] = x, y
    return (a, torch.as_tensor(bi.from_ints(a, pack.L16), device=dev),
            b, torch.as_tensor(bi.from_ints(b, pack.L16), device=dev))


@pytest.mark.parametrize("k", sorted(WIDTH_BITS))
@pytest.mark.parametrize("kind", BARRETT_KINDS)
@pytest.mark.parametrize("B", _cooperative_batches("mulmod")
                         + (geometry.MULMOD_FULL_BATCH,))
def test_cooperative_mulmod_matches_plain_and_ints(dev, k, kind, B):
    m = _width_modulus(k, kind)
    pack = ops.pack_modulus(m)
    assert pack.L32 == k
    dm = pack.on(dev)
    a, at, b, bt = _mulmod_operands(random.Random(k * 41 + B), B, pack, dev)
    before = build.LAUNCHES["mulmod"]
    out = lm.mulmod_cuda(at, bt, dm)
    torch.cuda.synchronize()
    assert build.LAUNCHES["mulmod"] == before + (B > 0)
    assert torch.equal(out, lm.mulmod_plain(at, bt, dm))
    assert bi.to_ints(out) == [(x * y) % m for x, y in zip(a, b)]


@pytest.mark.parametrize("k", sorted(WIDTH_BITS))
@pytest.mark.parametrize("kind", BARRETT_KINDS)
def test_mulmod_broadcast_row_and_column_slice(dev, k, kind):
    """b as one row broadcast to the batch (stride 0, as the protocol's
    constant multiplies give it) and a as a column slice of a wider
    array (row stride 3 L16), as ``_reduce_into`` reads its chunks."""
    m = _width_modulus(k, kind)
    pack = ops.pack_modulus(m)
    dm = pack.on(dev)
    L, B = pack.L16, 130
    rng = random.Random(k * 43)
    wide, wide_t = _rows(rng, B, 3 * L, dev)
    a = [(x >> (16 * L)) & ((1 << (16 * L)) - 1) for x in wide]
    at = wide_t[:, L:2 * L]
    c = rng.getrandbits(16 * L)
    bt = torch.as_tensor(bi.from_ints([c], L), device=dev).expand(B, L)
    assert at.stride(0) == 3 * L and bt.stride(0) == 0
    out = lm.mulmod_cuda(at, bt, dm)
    torch.cuda.synchronize()
    assert torch.equal(out, lm.mulmod_plain(at.contiguous(),
                                            bt.contiguous(), dm))
    assert bi.to_ints(out) == [(x * c) % m for x in a]


@pytest.mark.parametrize("k", sorted(WIDTH_BITS))
@pytest.mark.parametrize("kind", ("random", "top1"))
@pytest.mark.parametrize("tpi", sorted({t for t, _ in
                                        geometry.SHAPES["mulmod"]}))
def test_mulmod_every_group_size_at_every_width(dev, k, kind, tpi):
    m = _width_modulus(k, kind)
    pack = ops.pack_modulus(m)
    dm = pack.on(dev)
    a, at, b, bt = _mulmod_operands(random.Random(k + tpi), 77, pack, dev)
    out = lm.mulmod_cuda(at, bt, dm, tpi=tpi)
    torch.cuda.synchronize()
    assert torch.equal(out, lm.mulmod_plain(at, bt, dm))
    assert bi.to_ints(out) == [(x * y) % m for x, y in zip(a, b)]


@pytest.mark.parametrize("k", sorted(WIDTH_BITS))
@pytest.mark.parametrize("kind", BARRETT_KINDS)
@pytest.mark.parametrize("B", _cooperative_batches("modexp_fixed[barrett]"))
def test_cooperative_modexp_fixed_barrett_matches_plain_and_ints(dev, k,
                                                                 kind, B):
    m = _width_modulus(k, kind)
    pack = ops.pack_modulus(m)
    assert pack.L32 == k
    dm = pack.on(dev)
    rng = random.Random(k * 47 + B)
    base, bt = _rows(rng, B, pack.L16, dev)
    for i, x in enumerate((0, m, (1 << (16 * pack.L16)) - 1)[:B]):
        base[i] = x
        bt[i] = torch.as_tensor(bi.from_ints([x], pack.L16)[0], device=dev)
    for e in (1, ALL_WINDOWS, rng.getrandbits(128)):
        windows = ops.mg.exp_windows(e)
        before = build.LAUNCHES["modexp_fixed[barrett]"]
        out = mx.modexp_fixed_cuda(bt, windows, dm, "barrett")
        torch.cuda.synchronize()
        assert build.LAUNCHES["modexp_fixed[barrett]"] == before + (B > 0)
        assert torch.equal(out, mx.modexp_fixed_plain(bt, windows, dm,
                                                      "barrett")), e
        assert bi.to_ints(out) == [pow(x, e, m) for x in base], e


@pytest.mark.parametrize("tpi", sorted({t for t, _ in
                                        geometry.SHAPES[
                                            "modexp_fixed[barrett]"]}))
@pytest.mark.parametrize("kind", ("random", "even"))
def test_modexp_fixed_barrett_every_group_size(dev, tpi, kind):
    """The Barrett body at the group sizes timed against the chosen one,
    at k = 64."""
    m = _width_modulus(64, kind)
    pack = ops.pack_modulus(m)
    dm = pack.on(dev)
    rng = random.Random(tpi + 5)
    base, bt = _rows(rng, 77, pack.L16, dev)
    e = rng.getrandbits(2048)
    windows = ops.mg.exp_windows(e)
    out = mx.modexp_fixed_cuda(bt, windows, dm, "barrett", tpi=tpi)
    torch.cuda.synchronize()
    assert torch.equal(out, mx.modexp_fixed_plain(bt, windows, dm,
                                                  "barrett"))
    assert bi.to_ints(out) == [pow(x, e, m) for x in base]


# ---------------------------------------------------------------------------
# per-row-modulus kernels (the serving path's cross-tenant launches)
# ---------------------------------------------------------------------------

ROWS_WIDTHS = (8, 32, 64, 128)
ROWS_BODIES = ("modexp_rows[barrett,win4]", "modexp_rows[barrett,binary]",
               "modexp_rows[montgomery,win4]",
               "modexp_rows[montgomery,binary]")
MONT_ROWS_BODIES = ROWS_BODIES[2:]


def _rows_moduli(k: int, odd_only: bool = False) -> list:
    """Three moduli of exactly 4k bytes: random odd, random even (odd for
    Montgomery), and one whose top byte is 1 (Barrett's quotient estimate
    is loosest there)."""
    rng = random.Random(k * 101)
    odd = rng.getrandbits(32 * k) | (1 << (32 * k - 1)) | 1
    top1 = (1 << (32 * k - 8)) | rng.getrandbits(32 * k - 8) | 1
    return [odd, odd - 2 if odd_only else odd - 1, top1]


def _rows_case(k: int, B: int, dev, odd_only: bool = False):
    """A per-row modulus over B rows cycling through three moduli."""
    ms = _rows_moduli(k, odd_only)
    per_row = [ms[i * i % 3] for i in range(B)]
    return per_row, ops.rows_modulus(per_row, 4 * k, dev)


def _rows_batches(body: str) -> tuple:
    per_block = geometry.launch_geometry(body, 1,
                                         geometry.MAX_WORDS).per_block
    return (1, 77, per_block + 1, 130)


def _rows_body(body: str) -> tuple:
    """(reduce_impl, method) of a ``modexp_rows[...]`` body."""
    impl, method = body[len("modexp_rows["):-1].split(",")
    return impl, method


MULMOD_ROWS_BODIES = ("mulmod_rows[montgomery]", "mulmod_rows[barrett]")


@pytest.mark.parametrize("k", ROWS_WIDTHS)
@pytest.mark.parametrize("odd", (True, False))
@pytest.mark.parametrize("B", _rows_batches("mulmod_rows[montgomery]")
                         + (geometry.MULMOD_FULL_BATCH + 3,))
def test_mulmod_rows_matches_plain_and_ints(dev, k, odd, B):
    """Full-width operands (any value below 2^{16 L16}), three moduli per
    launch, ragged batches and the batch from which smaller groups run:
    an all-odd table launches the Montgomery body, one with an even
    modulus the Barrett body (one row: its modulus is odd)."""
    per_row, rm = _rows_case(k, B, dev, odd)
    assert rm.montgomery == (odd or B == 1)
    body = MULMOD_ROWS_BODIES[0 if rm.montgomery else 1]
    rng = random.Random(k * 13 + B)
    a, at = _rows(rng, B, rm.table.L16, dev)
    b, bt = _rows(rng, B, rm.table.L16, dev)
    before = dict(build.LAUNCHES)
    out = lm.mulmod_rows_cuda(at, bt, rm)
    torch.cuda.synchronize()
    assert {n: build.LAUNCHES[n] - before[n] for n in MULMOD_ROWS_BODIES} \
        == {n: int(n == body) for n in MULMOD_ROWS_BODIES}
    assert torch.equal(out, lm.mulmod_rows_plain(at, bt, rm))
    want = [(x * y) % m for x, y, m in zip(a, b, per_row)]
    assert bi.to_ints(out) == want
    # a broadcast b row, as the wrappers take it
    out1 = lm.mulmod_rows_cuda(at, bt[:1].expand(B, -1), rm)
    assert bi.to_ints(out1) == [(x * b[0]) % m for x, m in zip(a, per_row)]


@pytest.mark.parametrize("k", ROWS_WIDTHS)
@pytest.mark.parametrize("body, tpi, threads", [
    (body, tpi, threads) for body in MULMOD_ROWS_BODIES
    for tpi in sorted({t for t, _ in geometry.SHAPES[body]})
    for threads in geometry.SWEEP_THREADS])
def test_mulmod_rows_every_group_size(dev, k, body, tpi, threads):
    """Every group and block size of both bodies, the Barrett body on an
    all-odd table too."""
    impl = body[len("mulmod_rows["):-1]
    per_row, rm = _rows_case(k, 77, dev, True)
    rng = random.Random(k + tpi)
    a, at = _rows(rng, 77, rm.table.L16, dev)
    b, bt = _rows(rng, 77, rm.table.L16, dev)
    out = lm.mulmod_rows_cuda(at, bt, rm, impl, tpi=tpi, threads=threads)
    torch.cuda.synchronize()
    assert bi.to_ints(out) == [(x * y) % m for x, y, m in zip(a, b, per_row)]


#: S1's and S2's sums and blinding products: rows at n^2 (k = 128) and
#: p^2-width n^2 of a 1,024-bit key (k = 64), over four tenants
S1_MULMOD_ROWS = [(B, k) for B in (576, 1152, 2304, 4608) for k in (64, 128)]


@pytest.mark.parametrize("B, k", S1_MULMOD_ROWS)
@pytest.mark.parametrize("body", MULMOD_ROWS_BODIES)
def test_mulmod_rows_bodies_at_s1_shapes(dev, B, k, body):
    """Both bodies at S1's and S2's shapes over four odd moduli (each
    tenant's rows together), operands up to 2^{32k} - 1: equal to the
    plain version on every row and to ints on sample rows."""
    impl = body[len("mulmod_rows["):-1]
    rng = random.Random(B + k)
    ms = [rng.getrandbits(32 * k) | (1 << (32 * k - 1)) | 1
          for _ in range(4)]
    per_row = [ms[i * 4 // B] for i in range(B)]
    rm = ops.rows_modulus(per_row, 4 * k, dev)
    a, at = _rows(rng, B, rm.table.L16, dev)
    b, bt = _rows(rng, B, rm.table.L16, dev)
    out = lm.mulmod_rows_cuda(at, bt, rm, impl)
    torch.cuda.synchronize()
    assert torch.equal(out, lm.mulmod_rows_plain(at, bt, rm, impl))
    sel = list(range(4)) + list(range(B - 4, B))
    got = bi.to_ints(out[torch.as_tensor(sel, device=dev)].cpu())
    assert got == [a[i] * b[i] % per_row[i] for i in sel]


def test_rows_launch_path_never_synchronizes(dev):
    """enc_rows, add_rows and matvec_rows of two tenants, and dec_rows up
    to its read-back, run under torch.cuda.set_sync_debug_mode("error"):
    no host upload, index check or launch waits for the device."""
    from repro_torch.core import paillier as gold
    from repro_torch.core import paillier_batch as pb
    keys = [gold.keygen(512, random.Random(s)) for s in (3, 4)]
    rng = random.Random(1)
    enc_items = [(k, [rng.getrandbits(40) for _ in range(n)],
                  [gold.rand_r(k, rng) for _ in range(n)])
                 for k, n in zip(keys, (5, 3))]
    Ks = [np.array([[[rng.getrandbits(20) for _ in range(3)]
                     for _ in range(2)]], dtype=object) for _ in keys]
    pb.dec_rows([(k, c) for k, c in zip(keys, pb.enc_rows(
        enc_items, device=dev))], device=dev)  # tables, kernels: warm
    torch.cuda.synchronize()
    # the detector sees what the launch path used to do: a read of a
    # device index and a blocking upload
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError):
            int(torch.arange(3, device=dev).max())
        with pytest.raises(RuntimeError):
            torch.as_tensor(np.arange(3), device=dev)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    real_to_ints = pb.bi.to_ints
    reads = []

    def to_ints(x):                 # the first read-back may wait
        reads.append(torch.cuda.get_sync_debug_mode())
        torch.cuda.set_sync_debug_mode(0)
        return real_to_ints(x)

    pb.bi.to_ints = to_ints
    torch.cuda.set_sync_debug_mode("error")
    try:
        cts = pb.enc_rows(enc_items, device=dev)
        sums = pb.add_rows([(k, c, c) for k, c in zip(keys, cts)],
                           device=dev)
        mv = pb.matvec_rows([(k, K, [c[:3]]) for k, K, c in
                             zip(keys, Ks, cts)], device=dev)
        plain = pb.dec_rows([(k, c) for k, c in zip(keys, cts)], device=dev)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        pb.bi.to_ints = real_to_ints
    assert reads == [2]
    assert plain == [ms for _, ms, _ in enc_items]
    for (k, ms, _), s, o in zip(enc_items, sums, mv):
        assert pb.dec_rows([(k, s)], device=dev)[0] == [
            2 * m % k.n for m in ms]
        assert o.shape[:2] == (1, 2)


@pytest.mark.parametrize("k", ROWS_WIDTHS)
@pytest.mark.parametrize("body, B", [(body, B) for body in ROWS_BODIES
                                     for B in _rows_batches(body)])
def test_modexp_rows_matches_plain_and_ints(dev, k, body, B):
    """Every body, three moduli per launch, per-row exponents 0, 1, one
    whose 4-bit windows take all 16 values and random 64-bit ones."""
    impl, method = _rows_body(body)
    per_row, rm = _rows_case(k, B, dev, impl == "montgomery")
    rng = random.Random(k * 17 + B)
    base, bt = _rows(rng, B, rm.table.L16, dev)
    exps, et = _rows(rng, B, 4, dev)
    for i, e in enumerate((0, 1, ALL_WINDOWS)[:B]):
        exps[i] = e
        et[i] = torch.as_tensor(bi.from_ints([e], 4)[0], device=dev)
    before = build.LAUNCHES[body]
    out = mx.modexp_rows_cuda(bt, et, rm, method, impl)
    torch.cuda.synchronize()
    assert build.LAUNCHES[body] == before + 1
    assert torch.equal(out, mx.modexp_rows_plain(bt, et, rm, method, impl))
    assert bi.to_ints(out) == [pow(x, e, m)
                               for x, e, m in zip(base, exps, per_row)]


@pytest.mark.parametrize("body, tpi, threads", [
    (body, tpi, threads) for body in MONT_ROWS_BODIES
    for tpi in sorted({t for t, _ in geometry.SHAPES[body]})
    for threads in geometry.SWEEP_THREADS])
def test_modexp_rows_montgomery_every_geometry(dev, body, tpi, threads):
    """Every group and block size the sweep times, at n^2 (k = 128)."""
    impl, method = _rows_body(body)
    per_row, rm = _rows_case(128, 77, dev, True)
    rng = random.Random(tpi * threads)
    base, bt = _rows(rng, 77, rm.table.L16, dev)
    exps, et = _rows(rng, 77, 4, dev)
    out = mx.modexp_rows_cuda(bt, et, rm, method, impl, tpi=tpi,
                              threads=threads)
    torch.cuda.synchronize()
    assert bi.to_ints(out) == [pow(x, e, m)
                               for x, e, m in zip(base, exps, per_row)]


@pytest.mark.parametrize("impl", ("montgomery", "barrett"))
@pytest.mark.parametrize("method", ("win4", "binary"))
def test_modexp_rows_long_exponents_at_n2(dev, impl, method):
    """2,048-bit exponents (r^n, c^lam) at k = 128, held against ints and
    the plain version."""
    per_row, rm = _rows_case(128, 5, dev, impl == "montgomery")
    rng = random.Random(5)
    base, bt = _rows(rng, 5, rm.table.L16, dev)
    exps, et = _rows(rng, 5, 128, dev)
    before = build.LAUNCHES[f"modexp_rows[{impl},{method}]"]
    out = ops.modexp_rows(bt, et, rm, method=method, reduce_impl=impl)
    assert build.LAUNCHES[f"modexp_rows[{impl},{method}]"] == before + 1
    assert bi.to_ints(out) == [pow(x, e, m)
                               for x, e, m in zip(base, exps, per_row)]
    assert torch.equal(out, mx.modexp_rows_plain(bt, et, rm, method, impl))


TREE_WIDTHS = (8, 32, 64, 128)
#: the sweep's (TPI, G) at n^2, each in blocks of one row and of at least
#: 128 threads
TREE_GEOMETRIES = [(tpi, G) for tpi in (8, 16, 32)
                   for G in (1, 2, 4, 8, 16, 32, 64)
                   if tpi * G <= geometry.TREE_MAX_THREADS[tpi]]


def _tree_case(k: int, R: int, N: int, impl: str, dev, seed: int):
    """R rows of N full-width factors over _rows_moduli's three moduli
    (an even one for Barrett), the per-row table, the R^N correction and
    the products as ints."""
    per_row, rm = _rows_case(k, R, dev, impl == "montgomery")
    rng = random.Random(seed)
    L16 = rm.table.L16
    xs = [rng.getrandbits(16 * L16) for _ in range(R * N)]
    xs[0] = (1 << (16 * L16)) - 1
    x = torch.as_tensor(bi.from_ints(xs, L16), device=dev).reshape(R, N, L16)
    corr = ops._tree_correction(rm.moduli, rm.table.L32, N, str(x.device)) \
        if impl == "montgomery" else None
    want = []
    for r, m in enumerate(per_row):
        p = 1
        for v in xs[r * N:(r + 1) * N]:
            p = p * v % m
        want.append(p)
    return rm, x, corr, want


@pytest.mark.parametrize("k", TREE_WIDTHS)
@pytest.mark.parametrize("N", (2, 3, 17, 192))
@pytest.mark.parametrize("impl", ("montgomery", "barrett"))
def test_prod_rows_kernel_matches_plain_and_ints(dev, monkeypatch, k, N,
                                                impl):
    """The product-tree kernel over three moduli (one even for Barrett)
    and over one (``ops.prod_mod``), full-width factors up to
    2^{16 L16} - 1, against its plain version and ints."""
    from repro_torch.kernels import prodtree
    R = 7
    rm, x, corr, want = _tree_case(k, R, N, impl, dev, k * 7 + N)
    body = f"prod_rows[{impl}]"
    before = build.LAUNCHES[body]
    out = prodtree.prod_rows_cuda(x, rm.table, rm.midx, impl, corr)
    torch.cuda.synchronize()
    assert build.LAUNCHES[body] == before + 1
    assert bi.to_ints(out) == want
    assert torch.equal(out, prodtree.prod_rows_plain(
        x, rm.table, rm.midx, impl, 4, corr))
    # the moduli pick the body: an even one takes Barrett, and the knob
    # leaves an odd one on Montgomery
    m = min(rm.moduli, key=lambda v: (v % 2 == (impl == "barrett"), v))
    xs = bi.to_ints(x.reshape(R * N, -1))
    monkeypatch.setenv("REPRO_REDUCE_IMPL", "barrett")
    got = bi.to_ints(ops.prod_mod(x, ops.pack_modulus(m)))
    ones = []
    for r in range(R):
        p = 1
        for v in xs[r * N:(r + 1) * N]:
            p = p * v % m
        ones.append(p)
    assert got == ones
    assert build.LAUNCHES[body] == before + 2


@pytest.mark.parametrize("impl", ("montgomery", "barrett"))
@pytest.mark.parametrize("tpi, G", TREE_GEOMETRIES)
def test_prod_rows_every_geometry(dev, impl, tpi, G):
    """Every group size, groups a row and block size the sweep times, at
    n^2 (k = 128): 9 rows (the last block partly past R) of 37 factors
    (not a multiple of G, and fewer than G at the widest)."""
    from repro_torch.kernels import prodtree
    rm, x, corr, want = _tree_case(128, 9, 37, impl, dev, tpi * G)
    cap = geometry.TREE_MAX_THREADS[tpi]
    for threads in sorted({max(tpi * G, 64), min(cap, max(tpi * G, 128))}):
        out = prodtree.prod_rows_cuda(x, rm.table, rm.midx, impl, corr,
                                      tpi=tpi, groups=G, threads=threads)
        torch.cuda.synchronize()
        assert bi.to_ints(out) == want, (threads,)


def test_prod_rows_strided_factors_and_one_factor(dev):
    """Factors read through row and factor strides (a slice of a wider
    tensor) give the contiguous result; N = 1 launches nothing."""
    rm, x, corr, want = _tree_case(64, 5, 6, "montgomery", dev, 3)
    wide = torch.zeros((5, 12, x.shape[2]), dtype=torch.int32, device=dev)
    wide[:, ::2] = x
    before = build.LAUNCHES["prod_rows[montgomery]"]
    assert bi.to_ints(ops.prod_rows(wide[:, ::2], rm)) == want
    assert torch.equal(ops.prod_rows(x[:, :1], rm), x[:, 0])
    assert build.LAUNCHES["prod_rows[montgomery]"] == before + 1


def test_rows_paillier_ops_on_card_equal_cpu(dev):
    """enc/dec/add/matvec rows over two 1,024-bit keys on the card give
    the CPU's results, and decryption inverts encryption."""
    from repro_torch.core import paillier as gold
    from repro_torch.core import paillier_batch as pb
    keys = [gold.keygen(1024, random.Random(s)) for s in (1, 2)]
    rng = random.Random(0)
    enc_items = [(k, [rng.getrandbits(60) for _ in range(n)],
                  [gold.rand_r(k, rng) for _ in range(n)])
                 for k, n in zip(keys, (9, 5))]
    Ks = [np.array([[[rng.getrandbits(40) for _ in range(4)]
                     for _ in range(3)] for _ in range(2)], dtype=object)
          for _ in keys]
    got = {}
    for where in ("cuda", "cpu"):
        cts = pb.enc_rows(enc_items, device=where)
        got[where] = (
            [bi.to_ints(c) for c in cts],
            pb.dec_rows([(k, c) for k, c in zip(keys, cts)], device=where),
            [bi.to_ints(c) for c in pb.add_rows(
                [(k, c, c) for k, c in zip(keys, cts)], device=where)],
            [bi.to_ints(c.reshape(-1, c.shape[-1])) for c in pb.matvec_rows(
                [(k, K, [c[:4], c[1:5]]) for k, K, c in zip(keys, Ks, cts)],
                device=where)])
    assert got["cuda"] == got["cpu"]
    assert got["cuda"][1] == [ms for _, ms, _ in enc_items]


def test_serving_engine_on_card_equals_solo_runs(dev):
    """Three gold tenants (two key widths) in one engine on the card: each
    equals its solo runtime run on the card, and the fused launches went
    through the per-row kernels."""
    from repro_torch.runtime import runner
    from repro_torch.serve.protocol_engine import ProtocolEngine
    inst = make_lasso(24, 32, sparsity=0.1, noise=0.01, seed=1)
    cfgs = {f"t{i}": protocol.ProtocolConfig(
        K=4, lam=0.05, iters=2, seed=i, key_bits=bits,
        spec=QuantSpec(1e6, -8.0, 8.0), cipher="gold", gold_batch=True)
        for i, bits in enumerate((128, 128, 256))}
    build.reset_launches()
    eng = ProtocolEngine(admission="concurrent")
    for tid, cfg in cfgs.items():
        eng.admit(inst.A, inst.y, cfg, tid=tid)
    res = eng.run()
    assert eng.stats()["serve"]["fused_launches"] > 0
    for body in ("mulmod_rows[montgomery]", "modexp_rows[montgomery,win4]"):
        assert build.LAUNCHES[body] > 0, build.LAUNCHES
    for tid, cfg in cfgs.items():
        rt, master, wl, mode = runner.build_runtime(inst.A, inst.y, cfg)
        master.start()
        rt.sched.run()
        solo = runner.collect_result(rt, master, wl, mode)
        assert res[tid].history.tobytes() == solo.history.tobytes(), tid
        assert report_core(res[tid].stats) == report_core(solo.stats), tid
        assert eng.tenants[tid].rt.box.rng.getstate() == \
            rt.box.rng.getstate(), tid


# ---------------------------------------------------------------------------
# the LM serving stack: card against CPU, float32 (TF32 off)
# ---------------------------------------------------------------------------

LM_ARCHS = ("codeqwen15_7b", "yi_9b", "granite_34b", "command_r_35b",
            "llama4_scout_17b_a16e", "qwen2_moe_a27b", "llava_next_34b",
            "seamless_m4t_medium", "xlstm_125m", "recurrentgemma_2b")


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_engine_on_card_equals_cpu(dev, arch):
    """Each reduced config in float32: the card's greedy tokens equal the
    CPU's, and its prefill and decode logits lie within 1e-3."""
    import dataclasses
    from repro_torch.configs import get_reduced
    from repro_torch.models import registry
    from repro_torch.serve.engine import Engine
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    m = registry.get_model(cfg)
    cpu = m.init(cfg, 0, "cpu")
    card = m.init(cfg, 0, "cpu").to(dev)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (2, 8), dtype=np.int32)
    frames = (rng.normal(0, 0.02, (2, 8, cfg.d_model)).astype(np.float32)
              if cfg.family == "encdec" else None)
    want = Engine(cfg, cpu).generate(prompts, 8, frames=frames)
    assert np.array_equal(Engine(cfg, card).generate(prompts, 8,
                                                     frames=frames), want)
    outs = []
    for params, d in ((cpu, torch.device("cpu")), (card, dev)):
        kw = {} if frames is None else {
            "frames": torch.as_tensor(frames, device=d)}
        cache = m.init_cache(cfg, 2, 9, device=d)
        lg, cache = m.prefill(params, torch.as_tensor(prompts, device=d)
                              .long(), cfg, cache, **kw)
        lg2, _ = m.decode_step(params, torch.as_tensor(want[:, 0], device=d)
                               .long(), cache, cfg)
        outs.append((lg.cpu(), lg2.cpu()))
    for a, b in zip(*outs):
        assert float((a - b).abs().max()) < 1e-3
