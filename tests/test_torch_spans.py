"""The port's wall-clock spans (``repro_torch.obs.trace.span``), its wait
counts (``obs.metrics.PROCESS``) and the benchmark's readers of them.

Under ``torch.profiler`` on the CPU a tiny ``run_protocol``,
``run_on_runtime`` and ``ProtocolEngine`` run each emit their layers'
spans, every name from ``trace.SPANS``, every step inside a phase or
round of its driver; with no profiler recording a span is the one shared
null context.  Every edge's Gamma_2 exponents reach the batched CRT
ModExp as int64, and the run's ``exps`` counters say so.  The readers ``portbench/metrics/{paillier_host_s,
exps_host_s,coalescer_host_s}.py`` count only names the program or the
harness emits, and give hand-computed values on a hand-made trace.
"""
import collections
import contextlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import bench, spans
from portbench.trace import TraceSummary
from repro_torch.core import protocol
from repro_torch.core.quantization import QuantSpec
from repro_torch.data.synthetic import make_lasso
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace
from repro_torch.runtime import coalesce, runner
from repro_torch.runtime.scheduler import Scheduler
from repro_torch.serve.protocol_engine import ProtocolEngine

ROOT = Path(__file__).resolve().parent.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
#: the benchmark's readers of the program's spans, by metric name
READERS = ("paillier_host_s.round", "paillier_host_s.serve",
           "exps_host_s.round", "coalescer_host_s.serve")
#: a driver's phases: every other span starts inside one
PHASES = ("driver.init", "driver.share", "driver.round", "driver.report")
ITERS = 2


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def inst():
    return make_lasso(8, 16, sparsity=0.1, noise=0.01, seed=1)


def _cfg(seed: int = 0):
    return protocol.ProtocolConfig(
        K=2, lam=0.05, iters=ITERS, cipher="gold", key_bits=96, seed=seed,
        spec=QuantSpec(delta=1e6, zmin=-8.0, zmax=8.0), device="cpu")


def _engine(A, y):
    eng = ProtocolEngine(seed=0)
    for i in range(2):
        eng.admit(A, y, _cfg(seed=i), tid=f"t{i}", device="cpu")
    return list(eng.run().values())


DRIVERS = {
    "protocol": (lambda A, y: [protocol.run_protocol(A, y, _cfg())], 1,
                 {"driver", "paillier"}),
    "runtime": (lambda A, y: [runner.run_on_runtime(A, y, _cfg())], 1,
                {"driver", "coalescer", "paillier"}),
    "engine": (_engine, 2, {"driver", "coalescer", "paillier"}),
}


def test_span_is_the_shared_null_context_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    one = trace.span("driver.round", "round=0")
    assert isinstance(one, contextlib.nullcontext)
    assert trace.span("paillier.exps") is one
    assert trace.begin("driver.round") is None
    trace.end(None)


@pytest.mark.parametrize("driver", sorted(DRIVERS))
def test_drivers_emit_their_layers_spans(driver, inst):
    run, jobs, layers = DRIVERS[driver]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        results = run(inst.A, inst.y)
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name().split(".")[0] in
              {n.split(".")[0] for n in trace.SPANS}]
    names = collections.Counter(name for name, _, _ in events)
    assert set(names) <= set(trace.SPANS), set(names) - set(trace.SPANS)
    assert {name.split(".")[0] for name in names} == layers
    assert names["driver.round"] == jobs * ITERS
    assert names["driver.init"] == names["driver.share"] == jobs
    phases = [(s, t) for name, s, t in events if name in PHASES]
    for name, s, t in events:
        if name in PHASES:
            continue
        # a step starts inside a phase; the runtime's containers (a
        # message, a callback) may straddle the round their code closes
        assert any(a <= s <= b for a, b in phases), name
        if name.startswith(("paillier.", "coalescer.pack", "coalescer.blind",
                            "coalescer.demux", "coalescer.group")):
            assert any(a <= s and t <= b for a, b in phases), name
    for res in results:   # no card, no waits
        stats = res.stats if driver == "protocol" else res.stats["runtime"]
        assert stats["waits"] == {}


@pytest.mark.parametrize("driver", ["protocol", "runtime"])
def test_edge_gamma2_reaches_the_kernels_as_int64(inst, driver,
                                                  monkeypatch):
    """Every edge's Gamma_2 block reaches ``_halves`` as int64, never
    boxed into Python ints: ``exps.int64`` counts every matvec exponent
    of the run and ``exps.reduced`` none (absent from the run's stats)."""
    from repro_torch.core import paillier_batch as pb
    seen = []
    halves = pb._halves

    def spy(bk, bp, bq, exps, *args, **kwargs):
        if args[0] is None:   # no scalar exponent: the matvec's
            seen.append(getattr(exps, "dtype", type(exps)))
        return halves(bk, bp, bq, exps, *args, **kwargs)

    monkeypatch.setattr(pb, "_halves", spy)
    before = dict(obs_metrics.PROCESS.counters)
    res = DRIVERS[driver][0](inst.A, inst.y)[0]
    stats = res.stats if driver == "protocol" else res.stats["runtime"]
    matvec_exps = sum(ops.get("modexp", 0)
                      for ops in res.stats["ops"].values())
    assert seen and set(seen) == {np.dtype(np.int64)}
    assert matvec_exps > 0
    assert obs_metrics.PROCESS.since(before, "exps.") == \
        {"exps.int64": matvec_exps}
    assert stats["exps"] == {"exps.int64": matvec_exps}


def test_readers_count_only_names_the_program_or_the_harness_emits():
    labels = spans.labels()
    for metric in READERS:
        module = bench._load(
            ROOT / "portbench" / "metrics" / f"{metric.rsplit('.', 1)[0]}.py",
            f"portbench.metrics.{metric.rsplit('.', 1)[0]}")
        counted = module.names()
        assert counted <= set(trace.SPANS) | labels, metric
        for prefix in module.PROGRAM:
            assert any(n.startswith(prefix) for n in trace.SPANS), prefix
        for prefix in module.HARNESS:
            assert any(n.startswith(prefix) for n in labels), prefix


#: a hand-made breakdown: [name, idle seconds]
GAPS = [["paillier.exps", 3.0], ["paillier_batch._norm_exps", 1.0],
        ["paillier.pack", 2.0], ["bigint.from_ints", 0.5],
        ["paillier_vec._reduce_into", 0.125],
        ["coalescer.pack", 0.25],
        ["coalesce.CrossTenantCoalescer._execute", 0.75],
        ["driver.round", 4.0], ["host: no span open", 1.0],
        ["aten::mul", 2.0]]


def _run(summary):
    return bench.RunRecord(
        tenants=2, rounds=5, laps=[1.0] * 10, window_s=10.0, setup_s=1.0,
        launches={}, shape_launches={}, serve=None, trace=summary,
        inputs={})


@pytest.mark.parametrize("metric,want", [
    ("paillier_host_s.round", (3.0 + 1.0 + 2.0 + 0.5 + 0.125) / 10),
    ("paillier_host_s.serve", (3.0 + 1.0 + 2.0 + 0.5 + 0.125) / 10),
    ("exps_host_s.round", (3.0 + 1.0) / 10),
    ("coalescer_host_s.serve", (0.25 + 0.75) / 10),
])
def test_readers_on_a_hand_made_trace(metric, want, monkeypatch):
    read = bench.reader(ROOT, metric)
    summary = TraceSummary(window_s=20.0, busy_s=5.0, function_s={},
                           device_ops=[], idle_gaps=GAPS)
    assert read(_run(summary)) == pytest.approx(want, rel=1e-12)
    assert read(_run(None)) is None
    # a program with no span table: nothing to read
    monkeypatch.delattr(trace, "SPANS")
    assert read(_run(summary)) is None


def test_readers_are_the_benchmarks_new_per_layer_entries():
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    for metric in READERS:
        entry = entries[metric]
        assert entry["source"] == "program_span" and entry["unit"] == \
            "s/round" and entry["better"] == "lower"
        assert callable(bench.reader(ROOT, metric))


@pytest.fixture
def counts():
    """The process's wait counts, restored after the test."""
    before = dict(obs_metrics.PROCESS.counters)
    yield obs_metrics.PROCESS
    obs_metrics.PROCESS.counters.clear()
    obs_metrics.PROCESS.counters.update(before)


def test_a_wait_site_adds_one_to_its_count(counts, monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    card = torch.device("cuda")
    before = dict(counts.counters)
    clock = protocol._PhaseClock(card)
    clock.lap(protocol.PHASE_INIT)
    assert counts.since(before) == {"wait.lap": 1}

    class Box:
        device, counter = card, None
    queue = coalesce.CoalesceQueue(Scheduler(), Box())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        queue._clock()
    assert counts.since(before) == {"wait.coalesce_clock": 1, "wait.lap": 1}
    assert synced == [card, card]
    assert "wait.coalesce_clock" in {
        e.name() for e in prof.profiler.kineto_results.events()}
    for _ in range(3):
        with trace.wait("wait.limbs"):
            pass
    assert counts.since(before)["wait.limbs"] == 3
    assert set(trace.WAITS) >= set(counts.since(before))
