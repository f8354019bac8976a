"""repro_torch's workload families, churn and secure aggregation vs the
JAX reference, end to end.

Every registered family (the paper's LASSO, ridge, logistic, elastic_net,
power_grid, the row-split consensus families, whose z-update aggregate
runs through secure aggregation, and streaming_lasso, which re-shares u3
mid-run) runs through ``repro.core.protocol`` and
``repro_torch.core.protocol`` (``device="cpu"``: the kernels' plain
versions) at the conformance sizes (K, N, ITERS, KEY_BITS = 4, 32, 3,
128 — ``tests/test_conformance.py``) under the plain, gold-scalar,
gold-batched and vec arms.  Then the churn matrix: every family under
``ChurnSchedule.quarter(K, 5)`` (25 % of the edges leave at t = 1 and
rejoin at t = 3) in the plain, plain-recycle and gold (scalar, recycling)
arms, and LASSO's churn run in the gold-batched arm.  The two packages must agree with zero tolerance in
the history bytes, the ordered ciphertext stream, the blinding rng's
final state and the RunReport core.

Also here: ``paillier_aggregate``/``plain_aggregate`` and the
``ChurnSchedule`` validation errors against the reference's, and the
zero mid-phase conversions of the batched arm (streaming re-shares and
the churn handoff included).
"""
import dataclasses
import random

import numpy as np
import pytest
import torch

from repro import workloads as rworkloads
from repro.core import churn as rchurn
from repro.core import paillier as rgold
from repro.core import protocol as rproto
from repro.core import secure_agg as rsa
from repro.core.bigint import to_ints as rto_ints
from repro.core.cipher_tensor import CipherTensor as RCipherTensor
from repro.core.quantization import QuantSpec as RQuantSpec
from repro.data.synthetic import make_lasso as rmake_lasso
from repro.obs.metrics import report_core as rreport_core
from repro_torch import workloads
from repro_torch.core import bigint as bi
from repro_torch.core import churn
from repro_torch.core import cipher_tensor as ctm
from repro_torch.core import paillier as gold
from repro_torch.core import protocol
from repro_torch.core import secure_agg as sa
from repro_torch.core.quantization import QuantSpec
from repro_torch.data.synthetic import make_lasso
from repro_torch.obs import metrics

# small tensors: one intra-op thread avoids oversubscribing the cores that
# the suite's parallel workers share
torch.set_num_threads(1)

K, N, ITERS, KEY_BITS = 4, 32, 3, 128     # Nk = 8 == BATCH_MIN
SPEC = dict(delta=1e6, zmin=-8.0, zmax=8.0)
WORKLOADS = ("lasso", "ridge", "logistic", "elastic_net", "power_grid",
             "consensus_lasso", "consensus_logistic", "streaming_lasso")
#: row-split instances use model width N/K, so every block is Nk = 8
ROW_SPLIT = {"consensus_lasso", "consensus_logistic"}
ARMS = {"plain": dict(cipher="plain"),
        "gold_scalar": dict(cipher="gold", gold_batch=False),
        "gold_batch": dict(cipher="gold", gold_batch=True),
        "vec": dict(cipher="vec")}
ENCRYPTED = [arm for arm in ARMS if arm != "plain"]
CHURN_ITERS = 5                           # leave at t = 1, rejoin at t = 3
CHURN_ARMS = {"plain": dict(cipher="plain"),
              "plain_recycle": dict(cipher="plain", recycle=True),
              "gold": dict(cipher="gold", gold_batch=False, recycle=True)}
PACKAGES = {"ref": (rproto, RQuantSpec, rworkloads, rchurn),
            "port": (protocol, QuantSpec, workloads, churn)}


def as_ints(c) -> list[int]:
    """Any arm's ciphertext batch of either package as Python ints; a
    port CipherTensor is decoded from its limbs and stays resident."""
    if isinstance(c, ctm.CipherTensor):
        return bi.to_ints(c.limbs)
    if isinstance(c, RCipherTensor):
        return c.to_ints()
    if isinstance(c, torch.Tensor):
        return bi.to_ints(c)                  # port vec limbs (B, L16)
    if isinstance(c, list):
        return [int(x) for x in c]
    arr = np.asarray(c)
    if arr.ndim == 1:                         # plain box: quantized ints
        return [int(x) for x in arr]
    return rto_ints(arr)                      # reference vec limbs


class RecordingBox:
    """Delegating wrapper that records the emitted ciphertext stream."""

    def __init__(self, box):
        self._box = box
        self.enc_stream: list[int] = []

    def __getattr__(self, attr):
        return getattr(self._box, attr)

    def encrypt(self, m):
        c = self._box.encrypt(m)
        self.enc_stream.extend(as_ints(c))
        return c


def run_both(mp, runs, A, y, make_cfg, workload_for=None, health_for=None):
    """Run ``make_cfg(pkg, module, spec_cls, churn_mod)`` through both
    packages with a recording box; ``runs[pkg]`` gets ``(result, box)``
    and ``runs["conversions"]`` the port run's CipherTensor conversions.
    ``workload_for(pkg)`` gives the explicit workload object and
    ``health_for(pkg)`` the ``health`` knob, if any."""
    for pkg, (module, spec_cls, _, churn_mod) in PACKAGES.items():
        recorders = {}

        def recording_make_box(*a, _real=module.make_box, **kw):
            box, key = _real(*a, **kw)
            recorders["box"] = RecordingBox(box)
            return recorders["box"], key

        mp.setattr(module, "make_box", recording_make_box)
        try:
            extra = {} if health_for is None else \
                {"health": health_for(pkg)}
            if pkg == "port":
                extra["device"] = "cpu"
            wl = None if workload_for is None else workload_for(pkg)
            ctm.reset_conversion_stats()
            res = module.run_protocol(
                A, y, make_cfg(pkg, module, spec_cls, churn_mod),
                workload=wl, **extra)
        finally:
            mp.undo()
        runs[pkg] = (res, recorders["box"])
    runs["conversions"] = dict(ctm.CONVERSIONS)
    return runs


def assert_runs_equal(ref, port, encrypted: bool):
    (rres, rbox), (pres, pbox) = ref, port
    assert pres.history.tobytes() == rres.history.tobytes()
    assert np.array_equal(pres.x, rres.x)
    assert pbox.enc_stream == rbox.enc_stream
    assert metrics.report_core(pres.stats) == rreport_core(rres.stats)
    assert metrics.validate_report_core(pres.stats) == []
    if encrypted:
        assert pbox.rng.getstate() == rbox.rng.getstate()


def family_case(name, iters, churn_for=None):
    """Per package: (workload object or None, instance, spec kwargs,
    cfg overrides) for one family, as ``tests/test_conformance.py``
    builds it: LASSO by name on the historical instance and the fixed
    spec; the rest from their defaults with a calibrated spec (over the
    churned membership when ``churn_for`` gives a schedule)."""
    out = {}
    for pkg, (_, _, wmod, churn_mod) in PACKAGES.items():
        if name == "lasso":
            mk = rmake_lasso if pkg == "ref" else make_lasso
            out[pkg] = (None, mk(24, N, sparsity=0.1, noise=0.01, seed=1),
                        dict(SPEC), {})
            continue
        wl = wmod.get_default(name)
        n = N // K if name in ROW_SPLIT else N
        inst = wl.make_instance(24, n, K, seed=1)
        sched = None if churn_for is None else churn_for(churn_mod)
        spec = wl.calibrate_spec(inst.A, inst.y, K, iters, churn=sched)
        out[pkg] = (wl, inst, dict(delta=spec.delta, zmin=spec.zmin,
                                   zmax=spec.zmax),
                    {"rho": wl.rho, "lam": wl.lam})
    (_, rinst, rspec, rover), (_, pinst, pspec, pover) = \
        out["ref"], out["port"]
    assert np.array_equal(rinst.A, pinst.A) and np.array_equal(rinst.y,
                                                               pinst.y)
    assert rspec == pspec and rover == pover
    return out


def _cfg(module, spec_cls, spec, over, **kw):
    base = dict(K=K, lam=0.05, iters=ITERS, seed=0, key_bits=KEY_BITS)
    base.update(over)
    base.update(kw)
    return module.ProtocolConfig(spec=spec_cls(**spec), **base)


@pytest.fixture(scope="module", params=WORKLOADS)
def family_runs(request):
    """Every arm of one family through both packages."""
    name = request.param
    case = family_case(name, ITERS)
    mp = pytest.MonkeyPatch()
    out = {}
    for arm, kw in ARMS.items():
        def make_cfg(pkg, module, spec_cls, churn_mod):
            _, _, spec, over = case[pkg]
            return _cfg(module, spec_cls, spec, over, workload=name, **kw)
        out[arm] = run_both(mp, {}, case["ref"][1].A, case["ref"][1].y,
                            make_cfg, lambda pkg: case[pkg][0])
    return name, out


@pytest.mark.parametrize("arm", ARMS)
def test_history_bytes_equal_reference(family_runs, arm):
    name, runs = family_runs
    ref, port = runs[arm]["ref"][0], runs[arm]["port"][0]
    assert port.history.tobytes() == ref.history.tobytes(), (name, arm)
    assert np.array_equal(port.x, ref.x)
    # Paillier is exact: every arm equals the plain integer chain
    assert port.history.tobytes() == \
        runs["plain"]["port"][0].history.tobytes(), (name, arm)


@pytest.mark.parametrize("arm", ARMS)
def test_ciphertext_stream_equal_reference(family_runs, arm):
    name, runs = family_runs
    ref, port = runs[arm]["ref"][1], runs[arm]["port"][1]
    reshares = 1 if name == "streaming_lasso" else 0   # all edges at t=2
    assert len(port.enc_stream) == K * (N // K) * (1 + 2 * ITERS + reshares)
    assert port.enc_stream == ref.enc_stream, (name, arm)


@pytest.mark.parametrize("arm", ENCRYPTED)
def test_rng_state_equal_reference(family_runs, arm):
    name, runs = family_runs
    assert runs[arm]["port"][1].rng.getstate() == \
        runs[arm]["ref"][1].rng.getstate(), (name, arm)


@pytest.mark.parametrize("arm", ARMS)
def test_report_core_equal_reference(family_runs, arm):
    name, runs = family_runs
    ref, port = runs[arm]["ref"][0], runs[arm]["port"][0]
    assert metrics.report_core(port.stats) == rreport_core(ref.stats), \
        (name, arm, metrics.diff_reports(port.stats, ref.stats))
    assert metrics.reports_equal_modulo_timing(
        port.stats, runs["plain"]["port"][0].stats) is (arm == "plain")


def test_gold_batch_converts_only_where_secure_agg_does(family_runs):
    """The batched arm keeps every ciphertext resident between protocol
    ops, streaming re-shares included; only the consensus families'
    secure aggregation hands ints across, one ``enc_vec`` per block per
    round, as the reference's does."""
    name, runs = family_runs
    conv = runs["gold_batch"]["conversions"]
    per_round = K if name in ROW_SPLIT else 0
    assert conv == {"to_ints": per_round * ITERS, "from_ints": 0}, name
    if name == "streaming_lasso":
        stats = runs["gold_batch"]["port"][0].stats
        assert stats["reshare_events"] == K          # every edge at t = 2


# ---------------------------------------------------------------------------
# churn matrix
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=WORKLOADS)
def churn_runs(request):
    """One family through the quarter schedule, every churn arm, both
    packages (each with its own ``ChurnSchedule``)."""
    name = request.param
    quarter = lambda churn_mod: churn_mod.ChurnSchedule.quarter(  # noqa: E731
        K, CHURN_ITERS)
    case = family_case(name, CHURN_ITERS, churn_for=quarter)
    mp = pytest.MonkeyPatch()
    out = {}
    for arm, kw in CHURN_ARMS.items():
        def make_cfg(pkg, module, spec_cls, churn_mod):
            _, _, spec, over = case[pkg]
            return _cfg(module, spec_cls, spec, over, workload=name,
                        iters=CHURN_ITERS, churn=quarter(churn_mod), **kw)
        out[arm] = run_both(mp, {}, case["ref"][1].A, case["ref"][1].y,
                            make_cfg, lambda pkg: case[pkg][0])
    return name, out


@pytest.mark.parametrize("arm", CHURN_ARMS)
def test_churn_run_equals_reference(churn_runs, arm):
    """History bytes, ciphertext stream (the rejoin's re-encrypted
    Γ₁(u3) included), rng state and report core, churn counts and
    recycled skips included."""
    name, runs = churn_runs
    ref, port = runs[arm]["ref"], runs[arm]["port"]
    assert_runs_equal(ref, port, encrypted=arm.startswith("gold"))
    churn_sec = port[0].stats["churn"]
    assert churn_sec["leaves"] == churn_sec["rejoins"] == 1, (name, arm)
    # the schedule and the recycled skips change nothing but op counts
    assert port[0].history.tobytes() == \
        runs["plain"]["port"][0].history.tobytes(), (name, arm)


def test_churn_recycles_lasso_after_the_rejoin(churn_runs):
    name, runs = churn_runs
    recycled = {arm: runs[arm]["port"][0].stats["churn"]["recycled"]
                for arm in CHURN_ARMS}
    assert recycled["plain"] == 0
    assert recycled["plain_recycle"] == recycled["gold"]
    if name == "lasso":
        assert recycled["gold"] > 0


@pytest.mark.parametrize("pkg", PACKAGES)
def test_fail_schedules_rejected(pkg):
    module, spec_cls, _, churn_mod = PACKAGES[pkg]
    inst = rmake_lasso(24, N, sparsity=0.1, noise=0.01, seed=1)
    sched = churn_mod.ChurnSchedule(K, [(1, 0, "fail")])
    cfg = _cfg(module, spec_cls, SPEC, {}, churn=sched)
    extra = {"device": "cpu"} if pkg == "port" else {}
    with pytest.raises(ValueError, match="fail events"):
        module.run_protocol(inst.A, inst.y, cfg, **extra)


def _error(fn):
    try:
        fn()
    except (ValueError, TypeError) as exc:
        return type(exc).__name__, str(exc)
    return None


CHURN_CASES = [
    ("kind", lambda m: m.ChurnEvent(1, 0, "explode")),
    ("round0", lambda m: m.ChurnEvent(0, 0, "leave")),
    ("negative_edge", lambda m: m.ChurnEvent(1, -1, "leave")),
    ("leave_absent", lambda m: m.ChurnSchedule(
        4, [(1, 0, "leave"), (2, 0, "leave")])),
    ("rejoin_present", lambda m: m.ChurnSchedule(4, [(1, 0, "rejoin")])),
    ("nobody_left", lambda m: m.ChurnSchedule(
        2, [(1, 0, "leave"), (1, 1, "fail")])),
    ("edge_range", lambda m: m.ChurnSchedule(4, [(1, 4, "leave")])),
    ("check_K", lambda m: m.ChurnSchedule.quarter(4, 6).check(3)),
    ("check_iters", lambda m: m.ChurnSchedule.quarter(4, 6).check(4, 4)),
    ("quarter_short", lambda m: m.ChurnSchedule.quarter(4, 2)),
    ("valid_quarter", lambda m: m.ChurnSchedule.quarter(8, 9, kind="fail")
     .check(8, 9)),
]


@pytest.mark.parametrize("case", [c for c, _ in CHURN_CASES])
def test_churn_schedule_validation_equals_reference(case):
    fn = dict(CHURN_CASES)[case]
    want = _error(lambda: fn(rchurn))
    assert _error(lambda: fn(churn)) == want
    assert (want is None) == (case == "valid_quarter")


@pytest.mark.parametrize("seed", (0, 7))
def test_churn_schedules_equal_reference(seed):
    for build in (lambda m: m.ChurnSchedule.quarter(8, 12, frac=0.4),
                  lambda m: m.ChurnSchedule.random(6, 20, seed=seed,
                                                   rate=0.3,
                                                   fail_frac=0.5)):
        ref, port = build(rchurn), build(churn)
        assert [dataclasses.astuple(e) for e in port.events] == \
            [dataclasses.astuple(e) for e in ref.events]
        assert port.counts() == ref.counts()
        assert port.has_fails == ref.has_fails
        assert port.max_round == ref.max_round


# ---------------------------------------------------------------------------
# secure aggregation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_el,crt", [(8, True), (5, True), (8, False)])
def test_paillier_aggregate_equals_reference(n_el, crt):
    """Batched (B >= 8, on the device's plain kernels here) and scalar
    workers: the same sum, rng state and plain mirror as the
    reference's."""
    key = gold.keygen(KEY_BITS, random.Random(3))
    rkey = rgold.keygen(KEY_BITS, random.Random(3))
    assert dataclasses.asdict(key) == dataclasses.asdict(rkey)
    spec, rspec = QuantSpec(**SPEC), RQuantSpec(**SPEC)
    data = np.random.default_rng(n_el).normal(0.0, 3.0, (3, n_el))
    data[0, 0] = 20.0                       # clipped by the protocol range
    blocks = list(data)
    r_port, r_ref = random.Random(5), random.Random(5)
    got = sa.paillier_aggregate(blocks, key, spec, rng=r_port, crt=crt,
                                device="cpu")
    want = rsa.paillier_aggregate(blocks, rkey, rspec, rng=r_ref, crt=crt)
    assert got.tobytes() == want.tobytes()
    assert r_port.getstate() == r_ref.getstate()
    plain = sa.plain_aggregate(blocks, spec)
    assert plain.tobytes() == rsa.plain_aggregate(blocks, rspec).tobytes()
    assert plain.tobytes() == got.tobytes()


def test_secure_agg_context_equals_reference():
    """``for_run``'s rng stream (seed ^ 0xA66), op counts and wire bytes."""
    key = gold.keygen(KEY_BITS, random.Random(3))
    rkey = rgold.keygen(KEY_BITS, random.Random(3))
    blocks = list(np.random.default_rng(1).normal(0.0, 2.0, (4, 8)))
    sums = []
    for wmod, proto, spec_cls, k, extra in (
            (rworkloads, rproto, RQuantSpec, rkey, {}),
            (workloads, protocol, QuantSpec, key, {"device": "cpu"})):
        counter = proto.OpCounter()
        counter.phase = proto.PHASE_ITERATE
        ctx = wmod.SecureAggContext.for_run(spec_cls(**SPEC), k, 11,
                                            counter, 64, **extra)
        sums.append((ctx.aggregate(blocks).tobytes(), counter.as_dict(),
                     ctx.traffic_bytes, ctx.rng.getstate()))
    assert sums[0] == sums[1]


# ---------------------------------------------------------------------------
# limb residency through re-shares and churn handoffs
# ---------------------------------------------------------------------------

def test_churn_handoff_stays_limb_resident_and_equals_reference():
    """LASSO's churn run in the gold-batched arm: zero mid-phase
    conversions through the handoff (the rejoin's re-encrypted Γ₁(u3)
    enters the next round's chain straight off its limbs, the recycled
    skips never materialize the cached chain), and equal to the
    reference's run."""
    inst = make_lasso(24, N, sparsity=0.1, noise=0.01, seed=1)
    mp = pytest.MonkeyPatch()

    def make_cfg(pkg, module, spec_cls, churn_mod):
        return _cfg(module, spec_cls, SPEC, {}, cipher="gold",
                    iters=CHURN_ITERS, recycle=True,
                    churn=churn_mod.ChurnSchedule.quarter(K, CHURN_ITERS))

    runs = run_both(mp, {}, inst.A, inst.y, make_cfg)
    assert runs["conversions"] == {"to_ints": 0, "from_ints": 0}
    assert_runs_equal(runs["ref"], runs["port"], encrypted=True)
    churn_sec = runs["port"][0].stats["churn"]
    assert churn_sec["leaves"] == churn_sec["rejoins"] == 1
    assert churn_sec["recycled"] > 0


def test_registry_equals_reference():
    assert workloads.names() == rworkloads.names()
    for name in workloads.names():
        assert workloads.REGISTRY[name].default_params == \
            rworkloads.REGISTRY[name].default_params
        port, ref = workloads.get_default(name), rworkloads.get_default(name)
        assert (port.split, port.streaming, port.uses_secure_agg,
                port.delta) == (ref.split, ref.streaming,
                                ref.uses_secure_agg, ref.delta)
    with pytest.raises(KeyError, match="unknown workload"):
        workloads.get("nope")
