"""repro_torch's serving path vs the JAX reference's.

The same seeded inputs go through ``repro`` and ``repro_torch``
(``device="cpu"``: the kernels' plain versions) at the reference's test
sizes (128- and 256-bit keys, K = 4, N = 32, 3 iterations), and the two
must agree with zero tolerance:

* the rows layer: ``rows_modulus``, ``mulmod_rows``, ``modexp_rows``
  (both ladders), ``prod_rows`` and ``enc_rows``/``dec_rows``/
  ``add_rows``/``matvec_rows`` on two keys, odd byte-length moduli, zero
  exponents and batches that are not powers of two; a short modulus and
  a width mismatch raise the reference's ``ValueError``;
* the ``ProtocolEngine``: the 8 workload families in one gold engine,
  and the ``vec`` and ``auto`` arms in smaller mixes — per tenant the
  RunReport core, the history bytes and the rng post-state, then
  ``stats()["serve"]``, the ``fused_log`` and the ``serve`` spans'
  names, categories, virtual times and attributes (the launch spans'
  host wall time left out); mixed key widths with staggered admission
  and cancellation, plain tenants staggered and cancelled, a churned
  tenant, and the span stream of a survivor;
* the cross-tenant queue over 256/512/1024-bit keys;
* ``knee``, ``autotune``, the knee cache (round trip, corrupt files,
  the device kind ``torch-cpu``), ``auto`` admission and
  ``tune_admission``;
* ``serve_sim --device cpu`` against the reference CLI's summary, its
  host wall fields and the port's ``device`` key left out.

The last test imports every module of the port, and ``chip_smoke.py``,
in a subprocess where importing ``jax`` or ``repro`` raises.
"""
import dataclasses
import functools
import importlib
import json
import os
import pkgutil
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro import workloads as rworkloads
from repro.core import paillier as rgold
from repro.core import paillier_batch as rpb
from repro.core import protocol as rproto
from repro.core.churn import ChurnSchedule as RChurn
from repro.core.quantization import QuantSpec as RQuantSpec
from repro.data.synthetic import make_lasso
from repro.kernels import ops as rops
from repro.launch import serve_sim as rserve_sim
from repro.obs import trace as rtrace
from repro.obs.metrics import report_core as rreport_core
from repro.runtime import coalesce as rcoalesce
from repro.runtime import dispatch as rdispatch
from repro.runtime.runner import run_on_runtime as rrun
from repro.runtime.scheduler import Scheduler as RScheduler
from repro.serve import protocol_engine as rpe
import repro_torch
from repro_torch import workloads
from repro_torch.core import bigint as bi
from repro_torch.core import paillier as gold
from repro_torch.core import paillier_batch as pb
from repro_torch.core import protocol
from repro_torch.core.churn import ChurnSchedule
from repro_torch.core.quantization import QuantSpec
from repro_torch.kernels import ops
from repro_torch.launch import serve_sim
from repro_torch.obs import trace as trace_mod
from repro_torch.obs.metrics import report_core
from repro_torch.runtime import coalesce, dispatch
from repro_torch.runtime.runner import run_on_runtime
from repro_torch.runtime.scheduler import Scheduler
from repro_torch.serve import protocol_engine as pe

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, N, ITERS, KEY_BITS = 4, 32, 3, 128    # Nk = 8 == BATCH_MIN
WORKLOADS = ("lasso", "ridge", "logistic", "elastic_net", "power_grid",
             "consensus_lasso", "consensus_logistic", "streaming_lasso")
ROW_SPLIT = {"consensus_lasso", "consensus_logistic"}
#: the adaptive arm prices routing off a hand-built table (3-part keys
#: are device wildcards in both packages)
SYNTH_TABLE = {"version": 1, "entries": {
    f"gold/{KEY_BITS}/8": {"enc": 1e-6, "dec": 1e-6, "add": 1e-3,
                           "matvec": 1e-3, "convert": 1e-8},
    f"vec/{KEY_BITS}/8": {"enc": 1e-3, "dec": 1e-3, "add": 1e-6,
                          "matvec": 1e-6, "convert": 1e-8},
}}
#: arm -> (cfg overrides, the families its engine serves)
ARMS = {
    "gold": (dict(cipher="gold", gold_batch=True), WORKLOADS),
    "vec": (dict(cipher="vec"), ("lasso", "consensus_lasso")),
    "auto": (dict(cipher="auto"), ("lasso", "logistic", "streaming_lasso")),
}
ALL_WINDOWS = 0xFEDCBA9876543210          # 4-bit windows 15, 14, ..., 0

PACKAGES = {
    "ref": dict(proto=rproto, spec=RQuantSpec, wl=rworkloads,
                engine=rpe.ProtocolEngine, trace=rtrace, core=rreport_core,
                run=rrun, churn=RChurn, dispatch=rdispatch),
    "port": dict(proto=protocol, spec=QuantSpec, wl=workloads,
                 engine=pe.ProtocolEngine, trace=trace_mod, core=report_core,
                 run=run_on_runtime, churn=ChurnSchedule,
                 dispatch=dispatch),
}


@pytest.fixture(scope="module")
def inst():
    return make_lasso(24, N, sparsity=0.1, noise=0.01, seed=1)


def _dev(pkg: str) -> dict:
    return {"device": "cpu"} if pkg == "port" else {}


def _cfg(pkg: str, **kw):
    P = PACKAGES[pkg]
    base = dict(K=K, lam=0.05, iters=ITERS, seed=0, key_bits=KEY_BITS,
                spec=P["spec"](delta=1e6, zmin=-8.0, zmax=8.0))
    base.update(kw)
    return P["proto"].ProtocolConfig(**base)


def _case(pkg: str, name: str, lasso_inst):
    """(workload, A, y, cfg overrides) — every family's encrypted block is
    Nk = 8, the reference's conformance grid."""
    P = PACKAGES[pkg]
    if name == "lasso":
        return None, lasso_inst.A, lasso_inst.y, {}
    wl = P["wl"].get_default(name)
    n = N // K if name in ROW_SPLIT else N
    winst = wl.make_instance(24, n, K, seed=1)
    spec = wl.calibrate_spec(winst.A, winst.y, K, ITERS)
    return wl, winst.A, winst.y, {"spec": spec, "rho": wl.rho,
                                  "lam": wl.lam}


def _box_rng(rt):
    box = rt.box
    return box.gold.rng if hasattr(box, "gold") else box.rng


def _serve_spans(tracer) -> list:
    """The serve spans without the launch spans' host wall time."""
    return [(s.name, s.cat, s.t, s.dur,
             {k: v for k, v in s.attrs.items() if k != "wall_ms"})
            for s in tracer.spans if s.cat == "serve"]


# ---------------------------------------------------------------------------
# the rows layer
# ---------------------------------------------------------------------------

def _rows_moduli(L8: int, n: int, seed: int) -> list:
    rng = random.Random(seed)
    return [rng.getrandbits(8 * L8) | (1 << (8 * L8 - 1)) | 1
            for _ in range(n)]


@pytest.mark.parametrize("L8", (25, 33))          # odd byte lengths
@pytest.mark.parametrize("method", ("win4", "binary"))
def test_rows_ops_match_reference(L8, method):
    """Per-row moduli (three cycling over 7 rows): mulmod_rows,
    modexp_rows (exponents 0, 1, all 16 windows, random) and prod_rows
    equal the reference's radix-256 rows ops and Python ints."""
    ms = _rows_moduli(L8, 3, L8)
    B = 7
    per_row = [ms[i % 3] for i in range(B)]
    rng = random.Random(L8 + len(method))
    a = [rng.getrandbits(8 * L8) for _ in range(B)]
    b = [rng.getrandbits(8 * L8) for _ in range(B)]
    exps = [0, 1, ALL_WINDOWS] + [rng.getrandbits(70) for _ in range(B - 3)]
    rm = ops.rows_modulus(per_row, L8, "cpu")
    assert [rm.moduli[i] for i in rm.midx.tolist()] == per_row
    m8, mu8 = rops.rows_modulus(per_row, L8)
    assert rops.unpack_rows(m8) == per_row
    L16 = rm.table.L16

    def limbs(xs, L):
        return torch.as_tensor(bi.from_ints(xs, L))

    got = bi.to_ints(ops.mulmod_rows(limbs(a, L16), limbs(b, L16), rm))
    ref = rops.unpack_rows(rops.mulmod_rows(
        rops.pack_rows(a, L8), rops.pack_rows(b, L8), m8, mu8))
    assert got == ref == [x * y % m for x, y, m in zip(a, b, per_row)]
    got = bi.to_ints(ops.modexp_rows(limbs(a, L16), limbs(exps, 5), rm,
                                     method=method))
    ref = rops.unpack_rows(rops.modexp_rows(
        rops.pack_rows(a, L8), rops.pack_rows(exps, 9), m8, mu8,
        method=method))
    assert got == ref == [pow(x, e, m) for x, e, m in zip(a, exps, per_row)]
    x = [rng.getrandbits(8 * L8 - 1) for _ in range(B * 3)]
    got = bi.to_ints(ops.prod_rows(limbs(x, L16).reshape(B, 3, L16), rm))
    ref = rops.unpack_rows(rops.prod_rows(
        np.asarray(rops.pack_rows(x, L8)).reshape(B, 3, L8), m8, mu8))
    assert got == ref == [x[3 * i] * x[3 * i + 1] * x[3 * i + 2] % m
                          for i, m in enumerate(per_row)]


def test_rows_modulus_refuses_short_and_wide_moduli():
    short = _rows_moduli(24, 1, 1)[0]              # 24 bytes, asked 25
    for mod, args in ((ops, ([short], 25, "cpu")), (rops, ([short], 25))):
        with pytest.raises(ValueError, match="does not fill 25"):
            mod.rows_modulus(*args)
    wide = _rows_moduli(26, 1, 1)[0]
    for mod, args in ((ops, ([wide], 25, "cpu")), (rops, ([wide], 25))):
        with pytest.raises(OverflowError):
            mod.rows_modulus(*args)


def test_rows_operands_and_index_are_checked():
    """The rows wrappers refuse operands of the wrong batch or width, and
    the kernels' index check refuses a row outside the table, a wrong
    dtype and a table on another device."""
    from repro_torch.kernels import build
    ms = _rows_moduli(25, 2, 3)
    rm = ops.rows_modulus([ms[0], ms[1], ms[0]], 25, "cpu")
    L16 = rm.table.L16
    x = torch.ones((3, L16), dtype=torch.int32)
    with pytest.raises(ValueError, match="limb tensor"):
        ops.mulmod_rows(x[:2], x[:2], rm)
    with pytest.raises(ValueError, match="limb tensor"):
        ops.mulmod_rows(torch.ones((3, L16 + 1), dtype=torch.int32), x, rm)
    with pytest.raises(ValueError, match="exp"):
        ops.modexp_rows(x, torch.ones((2, 1), dtype=torch.int32), rm)
    with pytest.raises(ValueError, match="prod_rows"):
        ops.prod_rows(x.reshape(3, 1, L16)[:2], rm)
    cpu = torch.device("cpu")
    assert build.require_index("t", rm, 3, cpu) is rm.midx
    bad = dataclasses.replace(rm, midx=torch.tensor([0, 2, 1],
                                                    dtype=torch.int32))
    with pytest.raises(ValueError, match="outside the table"):
        build.require_index("t", bad, 3, cpu)
    with pytest.raises(ValueError, match="int32 row index"):
        build.require_index("t", dataclasses.replace(
            rm, midx=rm.midx.long()), 3, cpu)
    with pytest.raises(ValueError, match="int32 row index"):
        build.require_index("t", rm, 4, cpu)
    assert rm.repeat(2).midx.tolist() == [0, 0, 1, 1, 0, 0]
    assert rm.repeat([1, 0, 2]).midx.tolist() == [0, 0, 0]
    assert rm.per_row().m16.shape == (3, L16)


@functools.lru_cache(maxsize=None)
def _key_pair(bits: int, seed: int):
    return (gold.keygen(bits, random.Random(seed)),
            rgold.keygen(bits, random.Random(seed)))


@pytest.mark.parametrize("bits", (128, 256))
def test_rows_paillier_ops_match_reference(bits):
    """Two keys of one n^2 width fused: enc/dec/add/matvec rows equal the
    reference's (batches of 7 and 5, zero matvec exponents), and the
    port's ops take its limb-resident ciphertexts."""
    (p1, r1), (p2, r2) = _key_pair(bits, 7), _key_pair(bits, 8)
    assert (p1.n, p2.n) == (r1.n, r2.n)
    if rpb.rows_sig(r1) != rpb.rows_sig(r2):
        pytest.skip("the two keys' n^2 differ in byte length")
    assert pb.rows_sig(p1) == rpb.rows_sig(r1)
    rng = random.Random(bits)
    ms1 = [0, 1, 2 ** 40, 999, 5, 6, 7]
    ms2 = [rng.randrange(p2.n) for _ in range(5)]
    rs1 = [rgold.rand_r(r1, rng) for _ in ms1]
    rs2 = [rgold.rand_r(r2, rng) for _ in ms2]
    c1, c2 = pb.enc_rows([(p1, ms1, rs1), (p2, ms2, rs2)], device="cpu")
    R1, R2 = rpb.enc_rows([(r1, ms1, rs1), (r2, ms2, rs2)])
    assert (bi.to_ints(c1), bi.to_ints(c2)) == (R1, R2)
    assert R1 == [rgold.encrypt_crt(r1, m, r) for m, r in zip(ms1, rs1)]
    assert pb.dec_rows([(p1, c1), (p2, R2)], device="cpu") == \
        rpb.dec_rows([(r1, R1), (r2, R2)]) == [ms1, ms2]
    a1, a2 = pb.add_rows([(p1, c1, R1), (p2, c2, c2)], device="cpu")
    assert [bi.to_ints(a1), bi.to_ints(a2)] == \
        rpb.add_rows([(r1, R1, R1), (r2, R2, R2)])
    Ks1 = np.array([[[rng.getrandbits(30) for _ in range(3)]
                     for _ in range(2)]], dtype=object)
    Ks2 = np.array([[[0, 0, 5], [1, 2, 3]], [[7, 0, 0], [0, 0, 0]]],
                   dtype=object)
    got = pb.matvec_rows([(p1, Ks1, [c1[:3]]),
                          (p2, Ks2, [R2[:3], c2[2:5]])], device="cpu")
    ref = rpb.matvec_rows([(r1, Ks1, [R1[:3]]),
                           (r2, Ks2, [R2[:3], R2[2:5]])])
    assert [[bi.to_ints(rows) for rows in t] for t in got] == ref


def test_rows_mismatched_widths_raise_in_both():
    (p128, r128), (p256, r256) = _key_pair(128, 7), _key_pair(256, 9)
    for mod, items in ((pb, [(p128, [1], [2]), (p256, [1], [2])]),
                       (rpb, [(r128, [1], [2]), (r256, [1], [2])])):
        kw = {"device": "cpu"} if mod is pb else {}
        with pytest.raises(ValueError, match="mismatched limb widths"):
            mod.enc_rows(items, **kw)


# ---------------------------------------------------------------------------
# the engine: 8 families in one gold engine, vec and auto mixes
# ---------------------------------------------------------------------------

def _serve(pkg: str, arm: str, lasso_inst) -> dict:
    over, families = ARMS[arm]
    table = SYNTH_TABLE if arm == "auto" else None
    P = PACKAGES[pkg]
    tracer = P["trace"].Tracer()
    eng = P["engine"](admission="concurrent", trace=tracer)
    for name in families:
        wl, A, y, fam = _case(pkg, name, lasso_inst)
        eng.admit(A, y, _cfg(pkg, workload=name, **{**over, **fam}),
                  tid=name, workload=wl, table=table, **_dev(pkg))
    return {"engine": eng, "results": eng.run(), "tracer": tracer}


@pytest.fixture(scope="module", params=sorted(ARMS))
def served(request, inst):
    return {"arm": request.param,
            **{pkg: _serve(pkg, request.param, inst) for pkg in PACKAGES}}


def test_engine_tenants_match_reference(served):
    """Per tenant: RunReport core, history bytes and rng post-state."""
    ref, port = served["ref"], served["port"]
    for tid, want in ref["results"].items():
        got = port["results"][tid]
        assert report_core(got.stats) == rreport_core(want.stats), tid
        assert got.history.tobytes() == want.history.tobytes(), tid
        assert _box_rng(port["engine"].tenants[tid].rt).getstate() == \
            _box_rng(ref["engine"].tenants[tid].rt).getstate(), tid


def test_engine_stats_and_fused_log_match_reference(served):
    ref, port = served["ref"]["engine"], served["port"]["engine"]
    assert port.stats() == ref.stats()
    assert port.collector.fused_log == ref.collector.fused_log
    if served["arm"] == "gold":      # the matrix must not pass vacuously
        assert port.stats()["serve"]["fused_launches"] > 0
    for tq_p, tq_r in zip(port.collector.queues, ref.collector.queues):
        assert (tq_p.tenant, tq_p.launches, tq_p.coalesced_ops,
                tq_p.launch_widths) == (tq_r.tenant, tq_r.launches,
                                        tq_r.coalesced_ops,
                                        tq_r.launch_widths)


def test_engine_serve_spans_match_reference(served):
    got = _serve_spans(served["port"]["tracer"])
    assert got == _serve_spans(served["ref"]["tracer"])
    assert {"serve:admit:lasso", "serve:start:lasso",
            "serve:done:lasso"} <= {name for name, *_ in got}


def test_engine_runtime_telemetry_matches_reference(served):
    """The per-tenant ``serve`` block and the deterministic runtime keys
    (launch counts, virtual completion times, the trace signature)."""
    for tid, want in served["ref"]["results"].items():
        got = served["port"]["results"][tid].stats["runtime"]
        want = want.stats["runtime"]
        assert got["serve"] == want["serve"], tid
        for key in ("iter_times", "virtual_time", "launches",
                    "coalesced_ops", "events", "trace"):
            assert got[key] == want[key], (tid, key)


# ---------------------------------------------------------------------------
# mixed widths, staggered admission, cancellation, churn
# ---------------------------------------------------------------------------

def test_mixed_widths_staggered_cancelled_match_reference(inst):
    """Gold tenants at 128 and 256 bits, one admitted late and one
    cancelled after a round, next to a vec tenant: every tenant equals
    the reference's, no launch mixes limb widths, and the cancelled one
    equals a solo run of the rounds it completed."""
    A, y = inst.A[:, :16], inst.y               # K = 2 edges of Nk = 8
    plan = [("a", dict(key_bits=128, seed=0), 0.0, None),
            ("b", dict(key_bits=256, seed=1), 0.0, None),
            ("c", dict(key_bits=128, seed=2), 0.004, None),
            ("d", dict(key_bits=256, seed=3), 0.0, 1),
            ("e", dict(key_bits=128, seed=4, cipher="vec"), 0.0, None)]
    out = {}
    for pkg in PACKAGES:
        P = PACKAGES[pkg]
        tracer = P["trace"].Tracer()
        eng = P["engine"](admission="concurrent", trace=tracer)
        for tid, kw, at, cancel in plan:
            eng.admit(A, y,
                      _cfg(pkg, **{"cipher": "gold", "gold_batch": True,
                                   "K": 2, "iters": 2, **kw}),
                      tid=tid, admit_at=at, cancel_after=cancel,
                      **_dev(pkg))
        out[pkg] = (eng, eng.run(), tracer)
    (reng, rres, rtr), (peng, pres, ptr) = out["ref"], out["port"]
    for tid, *_ in plan:
        assert report_core(pres[tid].stats) == \
            rreport_core(rres[tid].stats), tid
        assert pres[tid].history.tobytes() == rres[tid].history.tobytes()
        assert _box_rng(peng.tenants[tid].rt).getstate() == \
            _box_rng(reng.tenants[tid].rt).getstate(), tid
    assert peng.stats() == reng.stats()
    assert peng.collector.fused_log == reng.collector.fused_log
    assert _serve_spans(ptr) == _serve_spans(rtr)
    width = {tid: pb.rows_sig(peng.tenants[tid].rt.key)[1]
             for tid, *_ in plan}
    assert len(set(width.values())) == 2
    for entry in peng.collector.fused_log:
        assert {width[t] for t in entry["tenants"]} == \
            {entry["limb_bytes"]}, entry
    assert "e" not in {t for e in peng.collector.fused_log
                       for t in e["tenants"]}
    served = peng.stats()["serve"]["per_tenant"]
    assert served["d"]["rounds"] == 1 and served["d"]["cancelled"]
    assert served["c"]["started_at"] >= 0.004
    solo = run_on_runtime(A, y,
                          _cfg("port", cipher="gold", gold_batch=True, K=2,
                               key_bits=256, seed=3, iters=1),
                          device="cpu")
    assert report_core(pres["d"].stats) == report_core(solo.stats)


def test_plain_tenants_staggered_and_cancelled_match_reference(inst):
    """The reference's property test on a fixed plan: each tenant equals
    the reference's and a port solo run of the rounds it completed."""
    A, y = inst.A[:, :16], inst.y
    plan = [(0, 3, None, 0.0), (1, 2, 1, 0.013), (2, 1, None, 0.007),
            (3, 3, 2, 0.0)]
    out = {}
    for pkg in PACKAGES:
        eng = PACKAGES[pkg]["engine"](admission="concurrent")
        for i, iters, cancel, at in plan:
            eng.admit(A, y, _cfg(pkg, cipher="plain", K=2, seed=i,
                                 iters=iters),
                      tid=f"t{i}", admit_at=at, cancel_after=cancel,
                      **_dev(pkg))
        out[pkg] = (eng, eng.run())
    (reng, rres), (peng, pres) = out["ref"], out["port"]
    assert peng.stats() == reng.stats()
    for i, iters, cancel, _ in plan:
        tid = f"t{i}"
        effective = iters if cancel is None else min(iters, cancel)
        solo = run_on_runtime(A, y, _cfg("port", cipher="plain", K=2,
                                         seed=i, iters=effective),
                              device="cpu")
        assert report_core(pres[tid].stats) == report_core(solo.stats) \
            == rreport_core(rres[tid].stats), tid
        assert pres[tid].history.tobytes() == solo.history.tobytes()


@pytest.mark.parametrize("arm_kw", [
    dict(cipher="plain", recycle=True),
    dict(cipher="gold", gold_batch=False, recycle=True),
], ids=["plain_recycle", "gold_recycle"])
def test_churn_tenant_matches_reference(inst, arm_kw):
    """A quarter-schedule churn tenant next to a steady one keeps its
    churn telemetry and recycled-update savings: equal to the
    reference's and to the port's solo run."""
    churn_iters = 5
    out = {}
    for pkg in PACKAGES:
        P = PACKAGES[pkg]
        cfg = _cfg(pkg, iters=churn_iters,
                   churn=P["churn"].quarter(K, churn_iters), **arm_kw)
        eng = P["engine"](admission="concurrent")
        eng.admit(inst.A, inst.y, cfg, tid="churny", **_dev(pkg))
        eng.admit(inst.A, inst.y,
                  _cfg(pkg, cipher=arm_kw["cipher"], gold_batch=False,
                       seed=1), tid="steady", **_dev(pkg))
        out[pkg] = (cfg, eng.run())
    (_, rres), (cfg, pres) = out["ref"], out["port"]
    solo = run_on_runtime(inst.A, inst.y, cfg, device="cpu")
    got = pres["churny"].stats
    assert report_core(got) == report_core(solo.stats) == \
        rreport_core(rres["churny"].stats)
    assert got["churn"]["leaves"] == got["churn"]["rejoins"] == 1
    assert got["churn"]["recycled"] > 0
    assert pres["churny"].history.tobytes() == solo.history.tobytes()
    assert report_core(pres["steady"].stats) == \
        rreport_core(rres["steady"].stats)


def test_finished_tenant_does_not_perturb_survivors(inst):
    """Tenant a's span stream is the same whether its neighbour b was
    cancelled after round 1 or configured with iters=1, and equals the
    reference's."""

    def run_pair(pkg, b_iters, b_cancel):
        P = PACKAGES[pkg]
        tr = P["trace"].Tracer()
        eng = P["engine"](admission="concurrent")
        eng.admit(inst.A, inst.y, _cfg(pkg, cipher="gold",
                                       gold_batch=False),
                  tid="a", trace=tr, **_dev(pkg))
        eng.admit(inst.A, inst.y, _cfg(pkg, cipher="gold", gold_batch=False,
                                       seed=1, iters=b_iters),
                  tid="b", cancel_after=b_cancel, **_dev(pkg))
        eng.run()
        return tr.signature()

    got = run_pair("port", ITERS, 1)
    assert got == run_pair("port", 1, None) == run_pair("ref", ITERS, 1)


# ---------------------------------------------------------------------------
# the cross-tenant queue over mixed key sizes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("specs", [
    ((256, 3), (512, 2), (256, 5)),
    ((1024, 4), (512, 6), (1024, 2), (256, 3)),
])
def test_mixed_key_sizes_fuse_like_reference(specs):
    """Tenants over 256/512/1024-bit keys submitting ⊕ work (scalar gold
    boxes): results demux to the right tenant, clusters never mix limb
    widths, and the counters and ``fused_log`` equal the reference's."""
    out = {}
    for pkg, mods in (("port", (gold, Scheduler, coalesce, protocol)),
                      ("ref", (rgold, RScheduler, rcoalesce, rproto))):
        g, S, co, pr = mods
        sched = S(seed=0)
        col = co.CrossTenantCoalescer(sched)
        got, want = {}, {}
        for i, (bits, n_ops) in enumerate(specs):
            key = g.keygen(bits, random.Random(bits))
            box = pr.GoldBox(key, random.Random(i), batch=False,
                             counter=pr.OpCounter(), **_dev(pkg))
            tq = co.TenantQueue(sched, box, counter=box.counter,
                                tenant=f"t{i}", collector=col)
            c1 = [g.encrypt_crt(key, 10 + j, g.rand_r(key, box.rng))
                  for j in range(n_ops)]
            c2 = [g.encrypt_crt(key, 20 + j, g.rand_r(key, box.rng))
                  for j in range(n_ops)]
            want[i] = [(a * b) % key.n2 for a, b in zip(c1, c2)]
            tq.submit("add", (c1, c2), functools.partial(
                lambda i, res: got.__setitem__(i, [int(x) for x in res]),
                i))
        sched.run()
        assert got == want, pkg
        out[pkg] = (col.metrics_section(), col.fused_log)
    assert out["port"] == out["ref"]
    widths = {f"t{i}": (b * 2 + 7) // 8 for i, (b, _) in enumerate(specs)}
    for entry in out["port"][1]:
        assert len({widths[t] for t in entry["tenants"]}) == 1, entry


# ---------------------------------------------------------------------------
# admission tuner: knee, cache, auto admission
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("widths, tputs", [
    ([1, 2, 4, 8], [1.0, 2.0, 4.0, 8.0]),
    ([1, 2, 4, 8], [1.0, 2.0, 2.1, 2.15]),
    ([1, 2, 4], [1.0, 2.0, 0.5]),
    ([4], [3.0]),
])
def test_knee_matches_reference(widths, tputs):
    assert pe.knee(widths, tputs) == rpe.knee(widths, tputs)
    for mod in (pe, rpe):
        with pytest.raises(ValueError):
            mod.knee([], [])


def test_autotune_matches_reference():
    tput = {1: 1.0, 2: 2.0, 4: 2.05, 8: 100.0}
    out = {}
    for name, mod in (("port", pe), ("ref", rpe)):
        calls = []
        out[name] = (mod.autotune(lambda w: calls.append(w) or tput[w],
                                  (1, 2, 4, 8)), calls)
    assert out["port"] == out["ref"] == ((2, {1: 1.0, 2: 2.0, 4: 2.05}),
                                         [1, 2, 4])


def test_serve_knee_cache_roundtrip(tmp_path):
    p = str(tmp_path / "calib.json")
    kind = dispatch.device_kind("cpu")
    assert kind == "torch-cpu"
    assert dispatch.load_serve_knee(KEY_BITS, 8, path=p, kind=kind) is None
    dispatch.save_serve_knee(KEY_BITS, 8, 16, curve={1: 3.0, 16: 9.5},
                             path=p, kind=kind)
    assert dispatch.load_serve_knee(KEY_BITS, 8, path=p, kind=kind) == 16
    doc = json.loads(open(p).read())
    assert doc["entries"][f"{kind}/serve/{KEY_BITS}/8"] == {
        "window": 16, "rounds_per_sec": {"1": 3.0, "16": 9.5}}
    # coexists with calibrate()'s entries; other kinds never match
    doc["entries"]["torch-cpu/gold/128/8"] = {"enc": 1e-4}
    open(p, "w").write(json.dumps(doc))
    dispatch.save_serve_knee(256, 8, 4, path=p, kind=kind)
    assert dispatch.load_serve_knee(KEY_BITS, 8, path=p, kind=kind) == 16
    assert dispatch.load_serve_knee(KEY_BITS, 8, path=p,
                                    kind="torch-cuda-X") is None
    assert dispatch.lookup(json.loads(open(p).read()), "gold", 128, 8,
                           kind=kind) == {"enc": 1e-4}


@pytest.mark.parametrize("corruption", [
    "not json {",
    json.dumps({"version": -1, "entries": {}}),
    json.dumps({"version": dispatch.TABLE_VERSION, "entries": []}),
    json.dumps({"version": dispatch.TABLE_VERSION,
                "entries": {"torch-cpu/serve/128/8": {"window": 0}}}),
])
def test_corrupt_knee_cache_loads_none(tmp_path, corruption):
    p = tmp_path / "calib.json"
    p.write_text(corruption)
    assert dispatch.load_serve_knee(KEY_BITS, 8, path=str(p),
                                    kind="torch-cpu") is None


def _auto_engine(pkg, A, y, path, n):
    eng = PACKAGES[pkg]["engine"](admission="auto", calib_path=path)
    for i in range(n):
        eng.admit(A, y, _cfg(pkg, cipher="plain", K=2, seed=i),
                  tid=f"t{i}", **_dev(pkg))
    return eng, eng.run()


def test_auto_admission_uses_cached_knee(inst, tmp_path):
    A, y = inst.A[:, :16], inst.y
    p = str(tmp_path / "calib.json")
    dispatch.save_serve_knee(KEY_BITS, 8, 2, path=p, kind="torch-cpu")
    rp = str(tmp_path / "ref_calib.json")
    rdispatch.save_serve_knee(KEY_BITS, 8, 2, path=rp)
    (peng, pres), (reng, rres) = (_auto_engine("port", A, y, p, 3),
                                  _auto_engine("ref", A, y, rp, 3))
    assert peng.stats()["serve"]["window"] == 2
    assert peng.stats()["serve"]["auto_fallback_sequential"] is False
    assert peng.stats() == reng.stats()
    for tid in pres:
        assert report_core(pres[tid].stats) == rreport_core(rres[tid].stats)


def test_auto_admission_falls_back_sequential_on_corrupt_cache(inst,
                                                               tmp_path):
    A, y = inst.A[:, :16], inst.y
    p = tmp_path / "calib.json"
    p.write_text("{corrupt")
    (peng, pres), (reng, rres) = (_auto_engine("port", A, y, str(p), 2),
                                  _auto_engine("ref", A, y, str(p), 2))
    st = peng.stats()["serve"]
    assert st["window"] == 1 and st["auto_fallback_sequential"] is True
    assert peng.stats() == reng.stats()
    for tid in pres:
        solo = run_on_runtime(A, y, _cfg("port", cipher="plain", K=2,
                                         seed=int(tid[1:])), device="cpu")
        assert report_core(pres[tid].stats) == report_core(solo.stats) \
            == rreport_core(rres[tid].stats)


def test_tune_admission_persists_a_knee_auto_reads(inst, tmp_path):
    """The sweep on the CPU persists a window for ``torch-cpu`` that a
    later ``auto`` engine reads instead of falling back."""
    A, y = inst.A[:, :16], inst.y
    p = str(tmp_path / "calib.json")
    tuned = pe.tune_admission(A, y, _cfg("port", cipher="plain", K=2),
                              widths=(1, 2), calib_path=p, device="cpu")
    assert tuned["window"] in (1, 2) and set(tuned["curve"]) <= {1, 2}
    assert tuned["nk"] == 8 and tuned["key_bits"] == KEY_BITS
    assert dispatch.load_serve_knee(KEY_BITS, 8, path=p,
                                    kind="torch-cpu") == tuned["window"]
    eng, _ = _auto_engine("port", A, y, p, 2)
    assert eng.stats()["serve"]["window"] == tuned["window"]
    assert eng.stats()["serve"]["auto_fallback_sequential"] is False


def test_engine_refuses_reuse_duplicates_and_mixed_devices(inst):
    eng = pe.ProtocolEngine()
    cfg = _cfg("port", cipher="plain", K=2)
    eng.admit(inst.A[:, :16], inst.y, cfg, tid="t0", device="cpu")
    with pytest.raises(ValueError, match="duplicate"):
        eng.admit(inst.A[:, :16], inst.y, cfg, tid="t0", device="cpu")
    with pytest.raises(ValueError, match="after_round"):
        eng.cancel("t0", 0)
    with pytest.raises(ValueError, match="admission"):
        pe.ProtocolEngine(admission="eager")
    eng.run()
    with pytest.raises(RuntimeError, match="already ran"):
        eng.run()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device 'cuda' requested"):
            pe.ProtocolEngine().admit(inst.A[:, :16], inst.y, cfg)


def test_serve_is_a_trace_category(inst):
    assert "serve" in trace_mod.CATEGORIES
    tr = trace_mod.Tracer()
    eng = pe.ProtocolEngine(admission="sequential", trace=tr)
    eng.admit(inst.A[:, :16], inst.y, _cfg("port", cipher="plain", K=2),
              tid="t0", device="cpu")
    eng.run()
    names = {s.name for s in tr.spans if s.cat == "serve"}
    assert {"serve:admit:t0", "serve:start:t0", "serve:done:t0"} <= names


# ---------------------------------------------------------------------------
# the serve_sim CLI
# ---------------------------------------------------------------------------

#: summary fields that are host wall time, or the port's own
WALL_FIELDS = ("wall_s", "agg_rounds_per_sec", "device", "trace")


@pytest.mark.parametrize("args", [
    ["--tenants", "3", "--iters", "2", "--edges", "2", "--block", "8"],
    ["--tenants", "4", "--workloads", "lasso,ridge", "--iters", "2",
     "--edges", "2", "--block", "8", "--stagger", "0.003",
     "--admission", "sequential"],
], ids=["gold", "mixed_sequential"])
def test_serve_sim_cli_matches_reference(args, tmp_path, capsys):
    ref = rserve_sim.main(args + ["--trace", str(tmp_path / "r.json")])
    got = serve_sim.main(args + ["--device", "cpu",
                                 "--trace", str(tmp_path / "p.json")])
    capsys.readouterr()
    assert got["device"] == "torch-cpu"
    assert got["trace"]["spans"] == ref["trace"]["spans"]
    assert {k: v for k, v in got.items() if k not in WALL_FIELDS} == \
        {k: v for k, v in ref.items() if k not in WALL_FIELDS}
    assert got["fused_launches"] > 0 or "sequential" in args


def test_serve_sim_auto_tune_on_cpu(tmp_path, capsys):
    calib = str(tmp_path / "calib.json")
    got = serve_sim.main(["--tenants", "2", "--cipher", "plain", "--iters",
                          "1", "--edges", "2", "--block", "8",
                          "--admission", "auto", "--tune", "--tune-widths",
                          "1,2", "--calib-cache", calib, "--device", "cpu"])
    tuned = json.loads(capsys.readouterr().out.split("\n}\n")[0] + "\n}")
    assert got["window"] == tuned["tuned"]["window"]
    assert got["auto_fallback_sequential"] is False


# ---------------------------------------------------------------------------
# the port imports neither JAX nor the reference
# ---------------------------------------------------------------------------

def test_port_and_chip_smoke_import_without_jax():
    """Every module of ``repro_torch`` and ``chip_smoke.py`` import in a
    fresh interpreter in which importing ``jax`` or ``repro`` raises."""
    code = """
import importlib, importlib.abc, pkgutil, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"refused: {name}")
        return None

sys.meta_path.insert(0, Refuse())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
sys.path.insert(0, sys.argv[1])
importlib.import_module("chip_smoke")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print(len(names))
"""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", code, REPO], env=env,
                       capture_output=True, text=True, timeout=300,
                       cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    assert int(r.stdout.split()[-1]) > 40
    assert "serve.protocol_engine" in " ".join(
        m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch."))
