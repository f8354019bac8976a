"""repro_torch's protocol surface vs the JAX reference: the ``vec`` arm,
Algorithm 3 (collaborative mode), the health watchers and the tracer.

All on the CPU (``device="cpu"``: the kernels' plain versions) at the
conformance sizes (K, N, ITERS, KEY_BITS = 4, 32, 3, 128), with zero
tolerance:

* the ``vec`` arm at Delta = 1e6 (``plaintext_bits(8)`` = 44: the int64
  decryption path) and at Delta = 1e9 (64 bits > 62: the lossless
  Python-int path, still below the 128-bit n) — history bytes,
  ciphertext stream, rng state and report core equal to the reference's;
* ``collab_encrypt_vec`` equal to both packages' scalar
  ``collaborative_encrypt``, a ``collaborative=True`` run equal to the
  reference's (the discarded decryption assist ``reduce_p2`` included),
  and the batched edges' zero conversions and zero scalar loops;
* ``health=True`` runs, clean and with injected saturation, with
  ``stats["health"]`` and the alert spans' trace signatures equal to the
  reference's; the monitor, tracer and report helpers on their own;
* Gamma_1/Gamma_2 saturating beyond int64 as the reference's do (Gamma_1
  at the paper's Delta = 1e15 reaches 1e28).
"""
import dataclasses
import random

import numpy as np
import pytest
import torch

from repro.core import cipher_tensor as rctm
from repro.core import paillier as rgold
from repro.core import paillier_batch as rpb
from repro.core import protocol as rproto
from repro.core import quantization as rquant
from repro.core.quantization import QuantSpec as RQuantSpec
from repro.obs import health as rhealth
from repro.obs import metrics as rmetrics
from repro.obs import trace as rtrace
from repro_torch.core import bigint as bi
from repro_torch.core import cipher_tensor as ctm
from repro_torch.core import paillier as gold
from repro_torch.core import paillier_batch as pb
from repro_torch.core import protocol
from repro_torch.core import quantization as quant
from repro_torch.core.quantization import QuantSpec
from repro_torch.data.synthetic import make_lasso
from repro_torch.obs import health, metrics, trace
from test_torch_workloads import (K, KEY_BITS, N, PACKAGES, SPEC,
                                  assert_runs_equal, run_both)

# small tensors: one intra-op thread avoids oversubscribing the cores that
# the suite's parallel workers share
torch.set_num_threads(1)

ITERS = 3


@pytest.fixture(scope="module")
def inst():
    return make_lasso(24, N, sparsity=0.1, noise=0.01, seed=1)


def _cfg(module, spec_cls, spec=SPEC, **kw):
    base = dict(K=K, lam=0.05, iters=ITERS, seed=0, key_bits=KEY_BITS)
    base.update(kw)
    return module.ProtocolConfig(spec=spec_cls(**spec), **base)


def _both(inst, health_for=None, **kw):
    """One LASSO configuration through both packages (recorded boxes)."""
    def make_cfg(pkg, module, spec_cls, churn_mod):
        return _cfg(module, spec_cls, **kw)

    return run_both(pytest.MonkeyPatch(), {}, inst.A, inst.y, make_cfg,
                    health_for=health_for)


# ---------------------------------------------------------------------------
# the vec arm
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=(1e6, 1e9))
def vec_runs(request, inst):
    delta = request.param
    spec = dict(SPEC, delta=delta)
    runs = _both(inst, cipher="vec", spec=spec)
    plain = protocol.run_protocol(
        inst.A, inst.y, _cfg(protocol, QuantSpec, spec=spec,
                             cipher="plain"), device="cpu")
    return delta, runs, plain


def test_vec_arm_equals_reference(vec_runs):
    delta, runs, plain = vec_runs
    assert_runs_equal(runs["ref"], runs["port"], encrypted=True)
    assert len(runs["port"][1].enc_stream) == K * (N // K) * (1 + 2 * ITERS)
    # Paillier is exact: the vec arm equals the plain integer chain
    assert runs["port"][0].history.tobytes() == plain.history.tobytes()


def test_vec_arm_decrypt_path_follows_plaintext_bits(vec_runs):
    """Delta = 1e6: the chain fits int64 and decryption narrows on the
    device; Delta = 1e9: 64 bits, decoded losslessly as Python ints."""
    delta, runs, _ = vec_runs
    box = runs["port"][1]
    want_bits = QuantSpec(**dict(SPEC, delta=delta)).plaintext_bits(N // K)
    assert box.plain_bits == runs["ref"][1].plain_bits == want_bits
    assert want_bits == (44 if delta == 1e6 else 64)
    ct = box.encrypt(np.arange(8))
    out = box.decrypt(ct)
    assert out.dtype == (np.int64 if want_bits <= 62 else object)
    assert [int(v) for v in out] == list(range(8))


def test_vec_box_shares_the_gold_batch_key():
    key = gold.keygen(KEY_BITS, random.Random(3))
    vbox = protocol.VecBox(key, random.Random(4), device="cpu")
    gbox = protocol.GoldBox(key, random.Random(4), device="cpu")
    assert vbox._bk is gbox.batch_key()
    assert vbox._bk.device == torch.device("cpu")
    assert vbox.plain_bits == key.n.bit_length()


# ---------------------------------------------------------------------------
# Algorithm 3
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def collab_keys():
    key = gold.keygen(160, random.Random(0))
    rkey = rgold.keygen(160, random.Random(0))
    assert dataclasses.asdict(key) == dataclasses.asdict(rkey)
    return key, rkey


def test_collab_encrypt_vec_equals_scalar_in_both_packages(collab_keys):
    key, rkey = collab_keys
    ms = np.array([0, 1, 999_999, 2 ** 40] + [7] * 6, dtype=object)
    out, states = {}, {}
    for name, mod, k, batch, fn in (
            ("port_vec", protocol, key, True, "collab_encrypt_vec"),
            ("port_scalar", protocol, key, False, "collaborative_encrypt"),
            ("ref_vec", rproto, rkey, True, "collab_encrypt_vec"),
            ("ref_scalar", rproto, rkey, False, "collaborative_encrypt")):
        edge = mod.EdgeNode(0, None)
        extra = {"device": "cpu"} if mod is protocol and batch else {}
        edge.collab_setup(k.p2, k.phi_p2, k.g, batch=batch, **extra)
        rng = random.Random(1)
        call_kw = {"device": "cpu"} if name == "port_vec" else {}
        out[name] = getattr(mod, fn)(k, edge, ms, rng, **call_kw)
        states[name] = rng.getstate()
    assert len(set(map(tuple, out.values()))) == 1
    assert len(set(map(repr, states.values()))) == 1   # same mask + r draws
    assert [gold.decrypt(key, c) for c in out["port_vec"]] == \
        [int(m) for m in ms]


def test_collab_edges_never_run_scalar_loops(collab_keys, monkeypatch):
    """Batched routing: the masked p^2 ModExp and the p^2 reduction run on
    the limb kernels, never the scalar loops, and a CipherTensor reduces
    straight off its limbs (zero conversions)."""
    key, _ = collab_keys
    edge = protocol.EdgeNode(0, None)
    edge.collab_setup(key.p2, key.phi_p2, key.g, batch=True, device="cpu")
    monkeypatch.setattr(
        protocol.EdgeNode, "_collab_half_scalar",
        lambda self, es: pytest.fail("batched edge ran the scalar pow loop"))
    monkeypatch.setattr(
        protocol.EdgeNode, "_reduce_p2_scalar",
        lambda self, xs: pytest.fail("batched edge ran the scalar % loop"))
    masked = np.array([random.Random(2).getrandbits(80) for _ in range(8)],
                      dtype=object)
    assert edge.collab_encrypt_half(masked) == \
        [pow(key.g % key.p2, int(e) % key.phi_p2, key.p2) for e in masked]
    bk = pb.make_batch_key(key, "cpu")
    cts = pb.enc_ct(bk, list(range(9)), random.Random(5))
    ints = bi.to_ints(cts.limbs)
    ctm.reset_conversion_stats()
    assert edge.reduce_p2(cts) == [c % key.p2 for c in ints]
    assert ctm.CONVERSIONS == {"to_ints": 0, "from_ints": 0}
    assert not cts.ints_materialized
    assert edge.reduce_p2(ints) == [c % key.p2 for c in ints]


@pytest.fixture(scope="module", params=("gold_batch", "gold_scalar"))
def collab_runs(request, inst):
    """``collaborative=True`` through both packages, with every
    decryption assist's (discarded) output recorded."""
    batch = request.param == "gold_batch"
    mp = pytest.MonkeyPatch()
    assists = {}
    for pkg, (module, *_rest) in PACKAGES.items():
        real = module.EdgeNode.reduce_p2

        def spy(self, x_hat, _real=real, _out=assists.setdefault(pkg, [])):
            got = _real(self, x_hat)
            _out.append(list(got))
            return got
        mp.setattr(module.EdgeNode, "reduce_p2", spy)
    runs = run_both(pytest.MonkeyPatch(), {}, inst.A, inst.y,
                    lambda pkg, module, spec_cls, _: _cfg(
                        module, spec_cls, cipher="gold", collaborative=True,
                        gold_batch=batch))
    mp.undo()
    return request.param, runs, assists, runs["conversions"]


def test_collaborative_run_equals_reference(collab_runs, inst):
    arm, runs, assists, conversions = collab_runs
    assert_runs_equal(runs["ref"], runs["port"], encrypted=True)
    # one assist per edge per round, identical values in both packages
    assert len(assists["port"]) == K * ITERS
    assert assists["port"] == assists["ref"]
    # the assists' p^2 bytes are in the report, beyond a run without them
    # (the reference's: its non-collaborative report core equals the
    # port's, tests/test_torch_protocol.py)
    solo = rproto.run_protocol(inst.A, inst.y, _cfg(
        rproto, RQuantSpec, cipher="gold", gold_batch=arm == "gold_batch"))
    key = runs["port"][1].key
    extra = (key.p2.bit_length() + 7) // 8 * (N // K) * K * ITERS
    assert runs["port"][0].stats["traffic_bytes"]["edge->master"] == \
        solo.stats["traffic_bytes"]["edge->master"] + extra
    plain = protocol.run_protocol(inst.A, inst.y, _cfg(
        protocol, QuantSpec, cipher="plain"), device="cpu")
    assert runs["port"][0].history.tobytes() == plain.history.tobytes()
    if arm == "gold_batch":     # limb-resident end to end
        assert conversions == {"to_ints": 0, "from_ints": 0}


# ---------------------------------------------------------------------------
# health watchers and the tracer
# ---------------------------------------------------------------------------

HEALTH = {"ref": (rhealth, rtrace), "port": (health, trace)}


def _monitors():
    """A live monitor per package, each with a tracer of its own bound on
    a clock that counts the alerts' reads of it."""
    out = {}
    for pkg, (hmod, tmod) in HEALTH.items():
        tick = iter(range(10 ** 6))
        mon = hmod.HealthMonitor()
        tracer = tmod.Tracer()
        mon.bind(tracer, lambda _t=tick: float(next(_t)))
        out[pkg] = (mon, tracer)
    return out


@pytest.mark.parametrize("case", ("clean", "saturated"))
def test_health_section_equals_reference(inst, case):
    """A clean run fires nothing; a quantizer range that violates the
    clipping contract fires ``quant_saturation`` in both packages, with
    equal counters, alerts and alert spans."""
    spec = SPEC if case == "clean" else \
        dict(delta=1e6, zmin=-1e-3, zmax=1e-3)
    mons = _monitors()
    runs = _both(inst, health_for=lambda pkg: mons[pkg][0],
                 cipher="gold", gold_batch=False, spec=spec)
    assert_runs_equal(runs["ref"], runs["port"], encrypted=True)
    hp, hr = (runs[pkg][0].stats["health"] for pkg in ("port", "ref"))
    assert hp == hr
    assert hp["counters"]["rounds"] == ITERS
    assert hp["counters"]["quant_encodes"] == K * (1 + ITERS)
    watchers = [a["watcher"] for a in hp["alerts"]]
    if case == "clean":
        assert watchers == []
    else:
        assert "quant_saturation" in watchers
        assert hp["counters"]["quant_clipped_values"] > 0
    assert mons["port"][1].signature() == mons["ref"][1].signature()
    assert mons["port"][1].count("alert") == len(watchers)
    assert "health" not in metrics.report_core(runs["port"][0].stats)


def test_health_true_builds_a_live_monitor(inst):
    assert isinstance(health.as_monitor(True), health.HealthMonitor)
    assert health.as_monitor(False) is health.NULL_MONITOR
    mon = health.HealthMonitor()
    assert health.as_monitor(mon) is mon
    res = protocol.run_protocol(inst.A, inst.y, _cfg(
        protocol, QuantSpec, cipher="plain"), health=True, device="cpu")
    ref = rproto.run_protocol(inst.A, inst.y, _cfg(
        rproto, RQuantSpec, cipher="plain"), health=True)
    assert res.stats["health"] == ref.stats["health"]
    plain = protocol.run_protocol(inst.A, inst.y, _cfg(
        protocol, QuantSpec, cipher="plain"), device="cpu")
    assert "health" not in plain.stats
    assert metrics.reports_equal_modulo_timing(plain.stats, res.stats)


def _drive(mon):
    """Every watcher hook through its trigger, in one fixed sequence."""
    for t, step in enumerate([1.0, 0.5, 0.4, 90.0, 0.4] + [0.4] * 9):
        mon.observe_round(t, step)
    mon.observe_quant(0, 0, 64)
    mon.observe_quant(1, 3, 64)
    for t in range(4):
        mon.observe_stale(t, 3, 4)
    mon.observe_stale(4, 0, 4)
    for t, e in ((5, 0), (9, 1), (10, 2)):
        mon.observe_death(t, e)
    mon.observe_queue_depth(10)
    mon.observe_queue_depth(5000)
    return mon.health_section()


def test_watchers_equal_reference():
    mons = _monitors()
    assert _drive(mons["port"][0]) == _drive(mons["ref"][0])
    assert [a["watcher"] for a in mons["port"][0].alerts] == [
        "mse_divergence", "mse_stall", "quant_saturation", "stale_storm",
        "death_storm", "queue_blowup"]
    assert mons["port"][1].signature() == mons["ref"][1].signature()
    th = health.Thresholds(stall_window=2, saturation_frac=0.5)
    rth = rhealth.Thresholds(stall_window=2, saturation_frac=0.5)
    assert _drive(health.HealthMonitor(th)) == \
        _drive(rhealth.HealthMonitor(rth))
    for mod in (health, rhealth):
        with pytest.raises(TypeError, match="unknown health threshold"):
            mod.Thresholds(nope=1)
    null = health.NULL_MONITOR
    assert _drive(null) == {"alerts": [], "counters": {}}


def test_tracer_equals_reference():
    spans = []
    for tmod in (trace, rtrace):
        tr = tmod.Tracer()
        tr.add("enc", "crypto_op", t=0.5, dur=0.25, op="enc", n=8)
        tr.add("launch", "launch", t=1.0, wall_ms=3.5, shape="8x16")
        tr.add("alert:x", "alert", t=2.0, watcher="x")
        with pytest.raises(ValueError, match="unknown span category"):
            tr.add("bad", "nope", t=0.0)
        back = tmod.spans_from_dicts(tr.as_dicts())
        spans.append((tr.signature(), tr.as_dicts(), tr.count("alert"),
                      [s.key() for s in tr.by_cat("launch")],
                      [s.as_dict() for s in back]))
        assert tmod.as_tracer(False) is tmod.NULL
        assert tmod.NULL.signature() == [] and tmod.NULL.count("alert") == 0
    assert spans[0] == spans[1]
    assert trace.CATEGORIES == rtrace.CATEGORIES


def test_report_helpers_equal_reference(inst):
    res = protocol.run_protocol(inst.A, inst.y, _cfg(
        protocol, QuantSpec, cipher="plain"), device="cpu")
    other = protocol.run_protocol(inst.A, inst.y, _cfg(
        protocol, QuantSpec, cipher="plain", iters=2), device="cpu")
    a, b = res.stats, other.stats
    assert metrics.diff_reports(a, b, "x", "y") == \
        rmetrics.diff_reports(a, b, "x", "y")
    assert metrics.diff_reports(a, a) == []
    bad = [a, {"schema_version": 0}, [], dict(a, churn={"leaves": 1}),
           dict(a, ops={"init": {"enc": 1.5}})]
    for rep in bad:
        assert metrics.validate_report_core(rep, "r") == \
            rmetrics.validate_report_core(rep, "r")
    samples = [[], [3.0], list(np.random.default_rng(0).random(101))]
    for s in samples:
        assert metrics.summary(s) == rmetrics.summary(s)


# ---------------------------------------------------------------------------
# quantization beyond int64, and the batched helpers of this slice
# ---------------------------------------------------------------------------

def test_gamma_saturates_like_reference():
    """Gamma_1 at the paper's Delta = 1e15 exceeds int64 (Delta^2 / span
    ~ 3e28): the port's codes saturate exactly as the reference's XLA cast
    does (and NaN codes to 0)."""
    for spec in (dict(delta=1e15, zmin=-16.0, zmax=16.0), SPEC):
        x = np.array([np.nan, np.inf, -np.inf, -1e6, 1e6, 9.3e3, -9.3e3,
                      0.5, -0.25, 3.0])
        for name in ("gamma1", "gamma2"):
            got = getattr(quant, name)(x, QuantSpec(**spec))
            want = np.asarray(getattr(rquant, name)(x, RQuantSpec(**spec)))
            assert got.dtype == np.int64
            assert got.tolist() == want.tolist(), (spec, name)


def test_modexp_and_reduce_mod_vec_equal_reference():
    """Exponents several times wider than the modulus (as the unmask
    factors' are mod p^2), a width that is not a multiple of 4 limbs, and
    the int-list and resident forms of the reduction."""
    rng = random.Random(9)
    m = rng.getrandbits(128) | (1 << 127) | 1
    exps = [rng.getrandbits(300) for _ in range(9)] + [0, 1]
    base = rng.getrandbits(200)
    got = ctm.modexp_mod_vec(base, exps, m, device="cpu")
    assert got == rctm.modexp_mod_vec(base, exps, m)
    assert got == [pow(base, e, m) for e in exps]
    assert ctm.modexp_mod_vec(base, [], m, device="cpu") == []
    with pytest.raises(ValueError, match="nonnegative"):
        ctm.modexp_mod_vec(base, [-1], m, device="cpu")
    cs = [rng.getrandbits(400) for _ in range(10)]
    red = ctm.reduce_mod_vec(cs, m, device="cpu")
    assert red == rctm.reduce_mod_vec(cs, m) == [c % m for c in cs]
    assert ctm.reduce_mod_vec([], m, device="cpu") == []


def test_enc_vec_rn_pool_and_concat_equal_reference():
    key = gold.keygen(KEY_BITS, random.Random(3))
    rkey = rgold.keygen(KEY_BITS, random.Random(3))
    bk, rbk = pb.make_batch_key(key, "cpu"), rpb.make_batch_key(rkey)
    ms = list(range(-3, 9))
    r1, r2 = random.Random(6), random.Random(6)
    assert pb.enc_vec(bk, ms, r1) == rpb.enc_vec(rbk, ms, r2)
    assert r1.getstate() == r2.getstate()
    rs = pb.rand_r_vec(key, 9, random.Random(7))
    got = pb.rn_pool_limbs(bk, rs)
    assert got.device == torch.device("cpu")
    assert bi.to_ints(got) == [pow(r, key.n, key.n2) for r in rs] == \
        rctm.bi.to_ints(np.asarray(rpb.rn_pool_limbs(rbk, rs)))
    a = pb.enc_ct(bk, [1, 2, 3], random.Random(1))
    b = pb.enc_ct(bk, [4, 5], random.Random(2))
    both = ctm.concat([a, b])
    assert bi.to_ints(both.limbs) == bi.to_ints(a.limbs) + \
        bi.to_ints(b.limbs)
    assert not both.ints_materialized
    with pytest.raises(ValueError, match="zero"):
        ctm.concat([])
