"""repro_torch's adaptive dispatch, coalescing queue, ledger, roofline and
``edge_sim`` CLI vs the JAX reference.

* ``runtime.dispatch``: the calibration cache (write and reuse, recovery
  from corrupt or partial files, device keying — the port keys entries
  ``torch-cpu`` / ``torch-cuda-<card>`` and never reads an entry keyed by
  the JAX package's ``cpu``/``gpu``/``tpu`` — legacy 3-part wildcard
  keys), ``lookup``, ``CostModel``; ``AdaptiveBox`` routing on a
  hand-built table against the reference's box, and a ``cipher="auto"``
  run against the reference's with the same table (history, dispatch
  routes, the deterministic runtime keys).
* ``runtime.coalesce``: the queue's equivalences with direct box calls
  (plain and gold groups, holds, the hold horizon) against the
  reference's queue, ``c_matvec_many`` against per-edge ``c_matvec`` and
  the reference's limbs, the gold branch's fused int64 blocks against
  per-entry ``box.matvec``, ``fuse_sig``.
* ``launch.edge_sim --device cpu``: small plain and gold runs, the JSON
  summary equal to the reference CLI's; ``--trace`` writes a valid
  chrome trace.
* ``obs.ledger.record_run`` under ``REPRO_LEDGER`` in a tmp path (and
  off); ``analysis.roofline.limb_ops`` equal to the reference's (only
  the peak constant differs); ``kernels.compile_cache.stats``.
* Entry points that take a device raise for ``"cuda"`` without a card.

Everything runs on the CPU (``device="cpu"``), integer work with zero
tolerance; encrypted runs use 128-bit keys.
"""
import json
import math
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import roofline as rroofline
from repro.core import paillier as rgold
from repro.core import paillier_vec as rpv
from repro.core import protocol as rproto
from repro.core.quantization import QuantSpec as RQuantSpec
from repro.data.synthetic import make_lasso
from repro.launch import edge_sim as redge_sim
from repro.obs import ledger as rledger
from repro.runtime import coalesce as rcoalesce
from repro.runtime import dispatch as rdispatch
from repro.runtime import runner as rrunner
from repro.runtime.scheduler import Scheduler as RScheduler
from repro_torch.analysis import roofline
from repro_torch.core import bigint as bi
from repro_torch.core import paillier as gold
from repro_torch.core import paillier_vec as pv
from repro_torch.core import protocol
from repro_torch.core.quantization import QuantSpec
from repro_torch.kernels import compile_cache
from repro_torch.launch import edge_sim
from repro_torch.obs import chrome_trace, ledger
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.metrics import report_core
from repro_torch.runtime import coalesce, dispatch, runner
from repro_torch.runtime.scheduler import Scheduler

torch.set_num_threads(1)

SPEC = dict(delta=1e6, zmin=-8.0, zmax=8.0)
CPU = "torch-cpu"
FAKE_ENTRY = {"enc": 1.0, "add": 1.0, "matvec": 1.0, "dec": 1.0,
              "convert": 0.0}


def _table(gold_cheap=("enc", "dec"), bits=128, batch=16):
    """Hand-built table (3-part keys: any device kind): the listed ops
    cheap on gold, the rest on vec."""
    e = {}
    for op in dispatch.OPS:
        cheap = op in gold_cheap
        e[op] = (1e-6 if cheap else 1e-3, 1e-3 if cheap else 1e-6)
    return {"version": 1, "entries": {
        f"gold/{bits}/{batch}": {**{op: v[0] for op, v in e.items()},
                                 "convert": 1e-8},
        f"vec/{bits}/{batch}": {**{op: v[1] for op, v in e.items()},
                                "convert": 1e-8},
    }}


# ---------------------------------------------------------------------------
# calibration cache
# ---------------------------------------------------------------------------

def test_calibrate_writes_and_reuses_cache(tmp_path, monkeypatch):
    path = str(tmp_path / "calib.json")
    calls = []
    real = dispatch._measure_backend

    def counting(backend, *a, **kw):
        calls.append(backend)
        return real(backend, *a, **kw)

    monkeypatch.setattr(dispatch, "_measure_backend", counting)
    kw = dict(key_bits=(128,), backends=("plain", "gold"), path=path,
              device="cpu")
    t1 = dispatch.calibrate(batch_sizes=(8,), **kw)
    assert sorted(calls) == ["gold", "plain"]
    assert json.load(open(path)) == t1
    assert sorted(t1["entries"]) == [f"{CPU}/gold/128/8", f"{CPU}/plain/0/8"]
    assert set(t1["entries"][f"{CPU}/gold/128/8"]) == set(FAKE_ENTRY)
    calls.clear()
    assert dispatch.calibrate(batch_sizes=(8,), **kw) == t1
    assert calls == []          # fully served from disk
    dispatch.calibrate(batch_sizes=(8, 16), **kw)
    assert sorted(calls) == ["gold", "plain"]   # only the new grid point


@pytest.mark.parametrize("bad", [
    b"{truncated", b"[1, 2, 3]", b'"a string"',
    json.dumps({"version": 3, "entries": "nope"}).encode(),
    json.dumps({"version": 3, "entries": {f"{CPU}/plain/0/8": 7}}).encode(),
    json.dumps({"version": 1, "entries": {}}).encode()])
def test_calibrate_recovers_from_corrupted_or_partial_cache(tmp_path,
                                                            monkeypatch,
                                                            bad):
    monkeypatch.setattr(dispatch, "_measure_backend",
                        lambda *a, **kw: dict(FAKE_ENTRY))
    path = tmp_path / "calib.json"
    path.write_bytes(bad)
    t = dispatch.calibrate(key_bits=(64,), batch_sizes=(8,),
                           backends=("plain",), path=str(path),
                           device="cpu")
    assert t["version"] == dispatch.TABLE_VERSION == rdispatch.TABLE_VERSION
    assert dispatch.lookup(t, "plain", 0, 8, kind=CPU) == FAKE_ENTRY
    assert json.load(open(path))["entries"] == t["entries"]


def test_port_never_reads_the_reference_device_keys(tmp_path, monkeypatch):
    """A cache holding the JAX package's entries (kind ``cpu``) is not a
    calibration of the port: lookup misses them and calibrate measures
    its own, under ``torch-cpu``, beside them in the same file."""
    assert dispatch.device_kind("cpu") == CPU
    assert CPU != rdispatch.device_kind()
    path = tmp_path / "calib.json"
    jax_table = {"version": dispatch.TABLE_VERSION, "entries": {
        f"{rdispatch.device_kind()}/plain/0/8": {"enc": 9.0},
        "cpu/gold/128/8": dict(FAKE_ENTRY), "tpu/gold/128/8": {}}}
    path.write_text(json.dumps(jax_table))
    with pytest.raises(KeyError, match="no calibration"):
        dispatch.lookup(jax_table, "gold", 128, 8, kind=CPU)
    measured = []
    monkeypatch.setattr(dispatch, "_measure_backend",
                        lambda b, *a, **kw: measured.append(b)
                        or dict(FAKE_ENTRY))
    t = dispatch.calibrate(key_bits=(128,), batch_sizes=(8,),
                           backends=("plain",), path=str(path),
                           device="cpu")
    assert measured == ["plain"]
    assert t["entries"][f"{CPU}/plain/0/8"] == FAKE_ENTRY
    assert t["entries"]["cpu/gold/128/8"] == FAKE_ENTRY   # kept, unread
    # the port's own default file is not the reference's
    monkeypatch.delenv("REPRO_CALIB_CACHE", raising=False)
    assert dispatch.cache_path().endswith(
        "repro_torch/dispatch_calib.json")
    assert dispatch.cache_path() != rdispatch.cache_path()


def test_lookup_legacy_wildcards_and_nearest_entry(tmp_path):
    t = _table(batch=16)
    for d in (dispatch, rdispatch):
        kind = {"kind": CPU} if d is dispatch else {}
        assert d.lookup(t, "gold", 128, 999, **kind) \
            == t["entries"]["gold/128/16"]
        assert d.lookup(t, "vec", 127, 16, **kind) \
            == t["entries"]["vec/128/16"]
        with pytest.raises(KeyError, match="no calibration"):
            d.lookup(t, "plain", 0, 16, **kind)
    legacy = {"version": dispatch.TABLE_VERSION,
              "entries": {"gold/128/16": dict(FAKE_ENTRY),
                          f"{CPU}/gold/128/8": {"enc": 2.0},
                          "torch-cuda-X/gold/128/8": {"enc": 1.0}}}
    path = tmp_path / "calib.json"
    path.write_text(json.dumps(legacy))
    t = dispatch.calibrate(backends=(), path=str(path), device="cpu")
    assert dispatch.lookup(t, "gold", 128, 8, kind=CPU) == {"enc": 2.0}
    assert dispatch.lookup(t, "gold", 128, 8, kind="torch-cuda-X") \
        == {"enc": 1.0}
    assert dispatch.lookup(t, "gold", 128, 8, kind="torch-cuda-Y") \
        == FAKE_ENTRY


def test_calibrate_warm_key_invokes_warmup_hook(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(dispatch.pb, "warmup",
                        lambda bk, shapes: calls.append(
                            (bk.key, str(bk.device), tuple(shapes))))
    monkeypatch.setattr(dispatch, "_measure_backend",
                        lambda *a, **kw: dict(FAKE_ENTRY))
    key = gold.keygen(96, random.Random(0))
    path = str(tmp_path / "calib.json")
    kw = dict(key_bits=(96,), batch_sizes=(8,), backends=("plain",),
              path=path, warm_key=key, device="cpu")
    dispatch.calibrate(**kw)
    assert calls == [(key, "cpu", (8,))]
    dispatch.calibrate(warm_shapes=(4, (1, 2, 3)), **kw)
    assert calls[1] == (key, "cpu", (4, (1, 2, 3)))


def test_serve_knee_round_trip(tmp_path):
    path = str(tmp_path / "calib.json")
    assert dispatch.load_serve_knee(128, 16, path=path, kind=CPU) is None
    dispatch.save_serve_knee(128, 16, 3, curve={1: 2.0, 3: 5.0}, path=path,
                             kind=CPU)
    assert dispatch.load_serve_knee(128, 16, path=path, kind=CPU) == 3
    assert dispatch.load_serve_knee(128, 16, path=path, kind="x") is None
    (tmp_path / "calib.json").write_text("{bad")
    assert dispatch.load_serve_knee(128, 16, path=path, kind=CPU) is None


def test_cost_model_matches_reference():
    for n in (1, 8, 48):
        assert dispatch.CostModel().edge_step_cost(n) \
            == rdispatch.CostModel().edge_step_cost(n)
    cm = dispatch.CostModel.from_table(_table(), "vec", 128, 16, kind=CPU)
    assert cm.unit == rdispatch.CostModel.from_table(_table(), "vec", 128,
                                                     16).unit
    assert cm.unit["enc"] == 1e-3 and cm.unit["modexp"] == 1e-6


def test_cuda_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    key = gold.keygen(96, random.Random(0))
    inst = make_lasso(12, 12, sparsity=0.1, noise=0.01, seed=1)
    cfg = protocol.ProtocolConfig(K=3, iters=1, spec=QuantSpec(**SPEC))
    for call in (
            lambda: dispatch.device_kind(),
            lambda: dispatch.calibrate(backends=(),
                                       path=str(tmp_path / "c.json")),
            lambda: dispatch.AdaptiveBox(key, random.Random(1), _table()),
            lambda: runner.run_on_runtime(inst.A, inst.y, cfg),
            lambda: edge_sim.main(["--edges", "3", "--iters", "1"])):
        with pytest.raises(RuntimeError, match="device 'cuda' requested"):
            call()


# ---------------------------------------------------------------------------
# adaptive box and cipher="auto"
# ---------------------------------------------------------------------------

def test_adaptive_box_routes_by_table_like_the_reference():
    key = gold.keygen(128, random.Random(0))
    rkey = rgold.keygen(128, random.Random(0))
    assert (key.n, key.g, key.lam) == (rkey.n, rkey.g, rkey.lam)
    boxes = (dispatch.AdaptiveBox(key, random.Random(1), _table(),
                                  device="cpu"),
             rdispatch.AdaptiveBox(rkey, random.Random(1), _table()))
    outs = []
    for box in boxes:
        m = np.arange(6, dtype=np.int64)
        c = box.encrypt(m)
        assert c.rep == "gold"
        s = box.add(c, box.encrypt(np.ones(6, dtype=np.int64)))
        assert s.rep == "vec"                   # add is cheap on vec
        t = box.matvec(np.eye(6, dtype=np.int64) * 2, s)
        assert t.rep == "vec"
        outs.append([int(v) for v in box.decrypt(t)])
        assert dict(box.choices) == {("enc", "gold"): 2, ("add", "vec"): 1,
                                     ("matvec", "vec"): 1,
                                     ("dec", "gold"): 1}
    assert outs[0] == outs[1] == [2 * (x + 1) for x in range(6)]


@pytest.mark.parametrize("gold_cheap", [("enc", "dec"), ("add", "matvec")])
def test_auto_cipher_run_matches_reference(gold_cheap):
    """cipher="auto" through run_protocol (delegated to the runtime) on
    the same hand-built table: history, routes and runtime keys equal the
    reference's."""
    inst = make_lasso(24, 48, sparsity=0.1, noise=0.01, seed=1)
    kw = dict(K=3, lam=0.05, iters=2, cipher="auto", key_bits=128, seed=0)
    ref = rrunner.run_on_runtime(inst.A, inst.y, rproto.ProtocolConfig(
        spec=RQuantSpec(**SPEC), **kw), table=_table(gold_cheap),
        trace=True)
    port = runner.run_on_runtime(inst.A, inst.y, protocol.ProtocolConfig(
        spec=QuantSpec(**SPEC), device="cpu", **kw),
        table=_table(gold_cheap), trace=True)
    assert port.history.tobytes() == ref.history.tobytes()
    assert report_core(port.stats) == report_core(ref.stats)
    r, p = ref.stats["runtime"], port.stats["runtime"]
    assert p["dispatch"] == r["dispatch"] and sum(p["dispatch"].values())
    for key in ("trace", "virtual_time", "iter_times", "events",
                "launches", "link_bytes"):
        assert p[key] == r[key], key
    plain = protocol.run_protocol(inst.A, inst.y, protocol.ProtocolConfig(
        spec=QuantSpec(**SPEC), device="cpu", **dict(kw, cipher="plain")))
    assert port.history.tobytes() == plain.history.tobytes()


# ---------------------------------------------------------------------------
# coalescing
# ---------------------------------------------------------------------------

def test_coalesce_plain_equivalent_to_direct_and_reference():
    counts = []
    for P, Q, S in ((protocol, coalesce, Scheduler),
                    (rproto, rcoalesce, RScheduler)):
        spec = (QuantSpec if P is protocol else RQuantSpec)(**SPEC)
        box = P.PlainBox(spec, 8, counter=P.OpCounter())
        sched = S()
        cq = Q.CoalesceQueue(sched, box, counter=box.counter)
        ms = [np.arange(8, dtype=np.int64) + i for i in range(5)]
        got = {}
        for i, m in enumerate(ms):
            cq.submit("enc", (m,), lambda c, i=i: got.setdefault(i, c))
        sched.run()
        assert cq.launches == 1 and cq.coalesced_ops == 5
        for i, m in enumerate(ms):
            assert np.array_equal(got[i], box.encrypt(m))
        counts.append((dict(box.counter.counts[P.PHASE_UNSET]),
                       cq.metrics_section()["ops_per_launch"]))
    assert counts[0] == counts[1]
    assert counts[0][0]["enc"] == 80


def test_coalesce_gold_add_and_dec_groups_match_reference():
    outs = []
    for P, Q, S, G in ((protocol, coalesce, Scheduler, gold),
                       (rproto, rcoalesce, RScheduler, rgold)):
        key = G.keygen(128, random.Random(0))
        kw = {"device": "cpu"} if P is protocol else {}
        box = P.GoldBox(key, random.Random(1), counter=P.OpCounter(),
                        batch_min=1, **kw)
        sched = S()
        cq = Q.CoalesceQueue(sched, box, counter=box.counter)
        c1 = box.encrypt(np.array([1, 2, 3]))
        c2 = box.encrypt(np.array([10, 20, 30]))
        out = {}
        cq.submit("add", (c1, c2), lambda r: out.setdefault("s", r))
        cq.submit("add", (c2, c2), lambda r: out.setdefault("s2", r))
        sched.run()
        cq.submit("dec", (out["s"],), lambda r: out.setdefault("d", r))
        cq.submit("dec", (out["s2"],), lambda r: out.setdefault("d2", r))
        sched.run()
        assert [int(v) for v in out["d"]] == [11, 22, 33]
        assert [int(v) for v in out["d2"]] == [20, 40, 60]
        outs.append((out["s"].to_ints(), cq.launches, cq.coalesced_ops))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("hold", [0, 10])
def test_coalesce_hold_merges_cross_tick_singletons(hold):
    m = np.arange(8, dtype=np.int64)
    stats = []
    for P, Q, S in ((protocol, coalesce, Scheduler),
                    (rproto, rcoalesce, RScheduler)):
        spec = (QuantSpec if P is protocol else RQuantSpec)(**SPEC)
        box = P.PlainBox(spec, 8, counter=P.OpCounter())
        sched = S()
        cq = Q.CoalesceQueue(sched, box, counter=box.counter, tick_s=1e-4,
                             hold_ticks=hold)
        got = {}
        cq.submit("enc", (m,), lambda c: got.setdefault(0, c))
        sched.at(3e-4, lambda: cq.submit("enc", (m + 1,),
                                         lambda c: got.setdefault(1, c)))
        sched.run()
        assert np.array_equal(got[1], box.encrypt(m + 1))
        stats.append((cq.launches, cq.coalesced_ops, cq.held_flushes,
                      sched.now, sched.events_run))
    assert stats[0] == stats[1]
    assert stats[0][:3] == ((1, 2, 1) if hold else (2, 0, 0))


def test_coalesce_hold_horizon_bounds_the_wait():
    box = protocol.PlainBox(QuantSpec(**SPEC), 4,
                            counter=protocol.OpCounter())
    sched = Scheduler()
    cq = coalesce.CoalesceQueue(sched, box, counter=box.counter,
                                tick_s=1e-4, hold_ticks=5)
    got = []
    cq.submit("enc", (np.arange(4, dtype=np.int64),), got.append)
    sched.run()
    assert len(got) == 1 and sched.now <= 7e-4
    assert cq.launches == 1 and cq.coalesced_ops == 0
    cq.submit("enc", (np.arange(4, dtype=np.int64),), got.append)
    sched.run()
    assert len(got) == 2 and cq.held_flushes == 2


def test_c_matvec_many_matches_per_edge_matvec_and_reference():
    key = gold.keygen(128, random.Random(0))
    vk, rvk = pv.make_vec_key(key), rpv.make_vec_key(key)
    rng = random.Random(2)
    B, M, N = 3, 4, 5
    Ks = np.array([[[rng.randrange(1 << 20) for _ in range(N)]
                    for _ in range(M)] for _ in range(B)], dtype=np.int64)
    ms = np.array([[rng.randrange(100) for _ in range(N)]
                   for _ in range(B)], dtype=np.int64)
    cs = []
    for b in range(B):
        rn = bi.from_ints(gold.make_r_pool(key, N, rng), vk.pack_n2.L16)
        cs.append(pv.encrypt_batch(vk, torch.as_tensor(ms[b]),
                                   torch.as_tensor(rn)))
    fused = coalesce.c_matvec_many(vk, torch.as_tensor(Ks), torch.stack(cs))
    assert fused.shape == (B, M, vk.pack_n2.L16)
    for b in range(B):
        assert torch.equal(fused[b], pv.c_matvec(vk, torch.as_tensor(Ks[b]),
                                                 cs[b])), b
    ref = rcoalesce.c_matvec_many(rvk, jnp.asarray(Ks),
                                  jnp.asarray(torch.stack(cs).numpy()))
    assert np.array_equal(fused.numpy(), np.asarray(ref))
    for b in range(B):
        ints = [int(c) for c in bi.to_ints(cs[b])]
        expect = []
        for i in range(M):
            acc = 1
            for j in range(N):
                acc = acc * pow(ints[j], int(Ks[b, i, j]), key.n2) % key.n2
            expect.append(acc)
        assert bi.to_ints(fused[b]) == expect


def test_coalesce_gold_matvec_group_int64_equals_per_entry_matvec():
    """The gold branch fuses stacked int64 blocks into one batched CRT
    matvec that keeps them int64 to the kernels, and returns each entry
    the ciphertexts of its own ``box.matvec`` and of ``pow``."""
    key = gold.keygen(128, random.Random(0))
    box = protocol.GoldBox(key, random.Random(1), counter=protocol.OpCounter(),
                           batch_min=1, device="cpu")
    rng = random.Random(3)
    B, M, N = 3, 4, 5
    Ks = [np.array([[rng.randrange(1 << 34) for _ in range(N)]
                    for _ in range(M)], dtype=np.int64) for _ in range(B)]
    cs = [box.encrypt(np.arange(N, dtype=np.int64) + 7 * b)
          for b in range(B)]
    sched = Scheduler()
    cq = coalesce.CoalesceQueue(sched, box, counter=box.counter)
    got = {}
    before = dict(obs_metrics.PROCESS.counters)
    for b in range(B):
        cq.submit("matvec", (Ks[b], cs[b]),
                  lambda r, b=b: got.setdefault(b, r))
    sched.run()
    assert cq.launches == 1 and cq.coalesced_ops == B
    assert obs_metrics.PROCESS.since(before, "exps.") == \
        {"exps.int64": B * M * N}
    for b in range(B):
        ints = cs[b].to_ints()
        expect = [math.prod(pow(ints[j], int(Ks[b][i, j]), key.n2)
                            for j in range(N)) % key.n2 for i in range(M)]
        assert got[b].to_ints() == box.matvec(Ks[b], cs[b]).to_ints() \
            == expect, b


def test_fuse_sig_matches_reference():
    key = gold.keygen(128, random.Random(0))
    rng = random.Random(1)
    cases = [(protocol.GoldBox(key, rng, device="cpu"),
              rproto.GoldBox(key, rng)),
             (protocol.GoldBox(key, rng, batch=False, device="cpu"),
              rproto.GoldBox(key, rng, batch=False)),
             (protocol.GoldBox(key, rng, crt=False, device="cpu"),
              rproto.GoldBox(key, rng, crt=False)),
             (protocol.PlainBox(QuantSpec(**SPEC), 4),
              rproto.PlainBox(RQuantSpec(**SPEC), 4))]
    for box, rbox in cases:
        for op in ("enc", "dec", "add", "matvec", "other"):
            assert coalesce.fuse_sig(box, op) == rcoalesce.fuse_sig(rbox, op)


# ---------------------------------------------------------------------------
# edge_sim CLI, ledger, roofline, build cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args", [
    ["--backend", "plain", "--edges", "4", "--iters", "4", "--topology",
     "ring", "--mode", "deadline", "--deadline", "0.5", "--slow-edge", "2",
     "--jitter", "1e-3", "--drop", "0.05", "--health"],
    ["--backend", "gold", "--key-bits", "128", "--edges", "3", "--block",
     "4", "--iters", "4", "--churn", "quarter", "--recycle"]],
    ids=["plain", "gold"])
def test_edge_sim_cli_matches_reference(args, tmp_path):
    trace = str(tmp_path / "trace.json")
    ref = redge_sim.main(args + ["--trace", trace])
    ref_doc = chrome_trace.load(trace)
    got = edge_sim.main(args + ["--device", "cpu", "--trace", trace])
    assert got.pop("device") == CPU
    assert got == ref
    doc = chrome_trace.load(trace)
    assert chrome_trace.validate(doc) == []
    strip = lambda d: [dict(s, wall_ms=None)  # noqa: E731
                       for s in d["spans"]]
    assert strip(doc) == strip(ref_doc)


def test_ledger_records_port_runs(tmp_path, monkeypatch):
    inst = make_lasso(24, 48, sparsity=0.1, noise=0.01, seed=1)
    kw = dict(K=3, lam=0.05, iters=3, seed=0)
    ref = rproto.run_protocol(inst.A, inst.y, rproto.ProtocolConfig(
        spec=RQuantSpec(**SPEC), **kw))
    path = tmp_path / "ledger.jsonl"
    monkeypatch.setenv("REPRO_LEDGER", str(path))
    sync = protocol.run_protocol(inst.A, inst.y, protocol.ProtocolConfig(
        spec=QuantSpec(**SPEC), device="cpu", **kw))
    rt = runner.run_on_runtime(inst.A, inst.y, protocol.ProtocolConfig(
        spec=QuantSpec(**SPEC), device="cpu", **kw))
    recs = ledger.load(str(path))
    assert [(r["driver"], r["mode"]) for r in recs] \
        == [("protocol", "sync"), ("runtime", "sync")]
    for r in recs:
        assert r["env"]["device"] == CPU
        assert r["env"]["torch"] == torch.__version__
        assert "jax" not in r["env"]
        assert (r["K"], r["iters"], r["seed"]) == (3, 3, 0)
    # the core signature is the reference's for the same run
    assert recs[0]["core_sig"] == recs[1]["core_sig"] \
        == rledger.core_signature(ref.stats) \
        == ledger.core_signature(sync.stats)
    assert recs[1]["virtual_time"] == rt.stats["runtime"]["virtual_time"]
    assert ledger.baseline_for(recs[0], recs) == []
    assert ledger.query(recs, kind="run", K=3) == recs
    monkeypatch.setenv("REPRO_LEDGER", "off")
    protocol.run_protocol(inst.A, inst.y, protocol.ProtocolConfig(
        spec=QuantSpec(**SPEC), device="cpu", **kw))
    assert len(ledger.load(str(path))) == 2
    assert ledger.record_run(sync.stats) is False


def test_roofline_limb_ops_match_reference():
    ops = {"init": {"enc": 12}, "iterate": {"enc": 30, "dec": 9,
                                            "modexp": 36864, "mulmod": 900}}
    for kw in (dict(), dict(method="binary", reduce_impl="barrett"),
               dict(exp_bits=64, method="win4", reduce_impl="montgomery")):
        for bits in (128, 2048):
            assert roofline.limb_ops(ops, bits, **kw) \
                == rroofline.limb_ops(ops, bits, **kw)
    got = roofline.achieved_vs_peak(ops, 2048, 3.7)
    want = rroofline.achieved_vs_peak(ops, 2048, 3.7)
    for key in ("limb_muls", "limb_muls_per_s", "by_op", "seconds"):
        assert got[key] == want[key]
    assert got["peak_limb_muls_per_s"] == 16.75e12 / 2 * 4
    assert got["fraction_of_peak"] == got["limb_muls_per_s"] / 3.35e13
    for m in ("binary", "win4", "fixed"):
        assert roofline.ladder_mulmods(m, 20) \
            == rroofline.ladder_mulmods(m, 20)


def test_compile_cache_reports_the_build_directory():
    s = compile_cache.stats()
    assert s["enabled"] is True and s["dir"] == compile_cache.enable()
    assert s["dir"].endswith("build/repro_torch")
    assert isinstance(s["entries"], int) and s["entries"] >= 0
