"""repro_torch's event-driven runtime vs the JAX reference's.

Every case of ``tests/test_runtime.py`` that runs the protocol runs here
through ``repro.runtime.runner.run_on_runtime`` and
``repro_torch.runtime.runner.run_on_runtime`` (``device="cpu"``: the
kernels' plain versions) on the same seeded inputs, and the two must
agree with zero tolerance in the history bytes, ``stale_events``, the
RunReport core and the deterministic keys of ``stats["runtime"]``
(:data:`RUNTIME_KEYS`, the tracer's timing-free ``signature()`` when
traced, the health section when monitored, the limb-op roofline's
counts).  Left out as timing: ``runtime["coalesce"]["launch_wall_ms"]``
(host/device wall per launch), ``runtime["profile"]`` (wall-clock
profiling events), ``runtime["compile_cache"]`` (each package's own
cache directory), the roofline's ``peak_limb_muls_per_s`` and
``fraction_of_peak`` (the port prices against the H100's peak), and the
port's ``stats["seconds"]``.

Cases: topologies; scheduler replay under jitter, loss and relays; sync
mode (plain on a star, gold on a ring, vec on a hierarchy, a non-LASSO
family); deadline mode (slow edge, the legacy inline semantics, the
no-cache wait, a tiny deadline, hold coalescing across rounds,
``coalesce_hold_ticks="auto"``, gold with a straggler behind a slow
link); lossy links; streaming re-shares; churn (span stream under
jitter, silent-failure detection, rejoin before detection, recycled
updates); health watchers.  Encrypted runs use 128- or 160-bit keys.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro import workloads as rworkloads
from repro.core import churn as rchurn
from repro.core import protocol as rproto
from repro.core.quantization import QuantSpec as RQuantSpec
from repro.data.synthetic import make_lasso
from repro.obs.metrics import report_core as rreport_core
from repro.runtime import LinkModel as RLinkModel
from repro.runtime import runner as rrunner
from repro.runtime import topology as rtopology
from repro_torch import workloads
from repro_torch.core import churn
from repro_torch.core import protocol
from repro_torch.core.quantization import QuantSpec
from repro_torch.obs.metrics import report_core
from repro_torch.runtime import LinkModel, runner, topology
from repro_torch.runtime.transport import Message

torch.set_num_threads(1)

SPEC = dict(delta=1e6, zmin=-8.0, zmax=8.0)
#: the deterministic keys of stats["runtime"], compared with ==
RUNTIME_KEYS = ("topology", "mode", "coalesce_hold_ticks", "virtual_time",
                "iter_times", "events", "max_queue_depth", "link_bytes",
                "retransmits", "coalesced_ops", "launches", "held_flushes")
#: the optional deterministic sections, compared whenever present
OPTIONAL_KEYS = ("trace", "dispatch", "health")
#: roofline keys that depend on the device's peak
PEAK_KEYS = ("peak_limb_muls_per_s", "fraction_of_peak")

PACKAGES = {
    "ref": dict(proto=rproto, spec=RQuantSpec, run=rrunner.run_on_runtime,
                topo=rtopology, link=RLinkModel, wl=rworkloads,
                churn=rchurn, core=rreport_core),
    "port": dict(proto=protocol, spec=QuantSpec, run=runner.run_on_runtime,
                 topo=topology, link=LinkModel, wl=workloads, churn=churn,
                 core=report_core),
}


@pytest.fixture(scope="module")
def inst():
    return make_lasso(24, 48, sparsity=0.1, noise=0.01, seed=1)


def _run(pkg, A, y, cfg_kw, *, spec=SPEC, topo=None, link=None,
         per_link=None, workload=None, churn_of=None, **kw):
    """One run in package ``pkg``: ``spec`` QuantSpec kwargs, ``topo``
    ``(name, kwargs)``, ``link``/``per_link`` LinkModel kwargs,
    ``workload`` ``(name, kwargs)``, ``churn_of`` a function of the
    package's churn module."""
    P = PACKAGES[pkg]
    cfg_kw = dict(cfg_kw, spec=P["spec"](**spec))
    if churn_of is not None:
        cfg_kw["churn"] = churn_of(P["churn"])
    if pkg == "port":
        kw["device"] = "cpu"
    if topo is not None:
        kw["topology"] = getattr(P["topo"], topo[0])(cfg_kw["K"],
                                                     **topo[1])
    if link is not None:
        kw["link"] = P["link"](**link)
    if per_link is not None:
        kw["per_link"] = {k: P["link"](**v) for k, v in per_link.items()}
    if workload is not None:
        kw["workload"] = P["wl"].get(workload[0], **workload[1])
    return P["run"](A, y, P["proto"].ProtocolConfig(**cfg_kw), **kw)


def both(A, y, cfg_kw, **kw):
    """The reference's and the port's runs of one configuration, held
    equal; returns ``(ref, port)``."""
    ref = _run("ref", A, y, cfg_kw, **kw)
    port = _run("port", A, y, cfg_kw, **kw)
    assert_same(ref, port)
    return ref, port


def assert_same(ref, port):
    assert port.history.tobytes() == ref.history.tobytes()
    assert port.x.tobytes() == np.asarray(ref.x).tobytes()
    assert port.stale_events == ref.stale_events
    assert report_core(port.stats) == rreport_core(ref.stats)
    r, p = ref.stats["runtime"], port.stats["runtime"]
    for key in RUNTIME_KEYS:
        assert p[key] == r[key], key
    for key in OPTIONAL_KEYS:
        assert (key in p) == (key in r), key
        if key in r:
            assert p[key] == r[key], key
    for key in ("launches", "coalesced_ops", "held_flushes",
                "ops_per_launch"):
        assert p["coalesce"][key] == r["coalesce"][key], key
    assert sorted(p["coalesce"]["launch_wall_ms"]) \
        == sorted(r["coalesce"]["launch_wall_ms"])
    assert ("roofline" in p) == ("roofline" in r)
    if "roofline" in r:
        strip = lambda d: {k: v for k, v in d.items()     # noqa: E731
                           if k not in PEAK_KEYS}
        assert strip(p["roofline"]) == strip(r["roofline"])
    assert set(port.stats["seconds"]) >= {"rounds"}


def _cfg(**kw):
    base = dict(K=3, lam=0.05, iters=8, cipher="plain", seed=0)
    base.update(kw)
    return base


# ---------------------------------------------------------------------------
# topology and scheduler
# ---------------------------------------------------------------------------

def test_topologies_match_reference():
    for k in (2, 5, 64, 128):
        for name in ("star", "ring", "full_mesh", "hierarchical"):
            t, rt = getattr(topology, name)(k), getattr(rtopology, name)(k)
            assert (t.kind, t.nodes, t.links) == (rt.kind, rt.nodes, rt.links)
            for dst in ("edge0", f"edge{k - 1}"):
                assert t.route("master", dst) == rt.route("master", dst)
    h = topology.hierarchical(8, fanout=4)
    assert h.route("master", "edge5") == ("master", "relay1", "edge5")
    assert topology.make("ring", 6).links == rtopology.make("ring", 6).links
    for bad, match in ((lambda: topology.star(1), "outside"),
                       (lambda: topology.ring(topology.MAX_EDGES + 1),
                        "outside"),
                       (lambda: topology.make("torus", 4),
                        "unknown topology")):
        with pytest.raises(ValueError, match=match):
            bad()


def test_scheduler_replays_the_reference_event_order(inst):
    """Jitter, losses and relays in play: the same seed gives the
    reference's span stream, retransmits and history."""
    ref, port = both(inst.A, inst.y, _cfg(iters=4),
                     topo=("hierarchical", dict(fanout=2)),
                     link=dict(jitter_s=2e-3, drop_prob=0.05,
                               timeout_s=5e-3), trace=True)
    sig = port.stats["runtime"]["trace"]
    assert len(sig) > 50 and port.stats["runtime"]["retransmits"] > 0
    assert {"phase", "launch", "message", "crypto_op"} \
        <= {entry[1] for entry in sig}


# ---------------------------------------------------------------------------
# sync mode
# ---------------------------------------------------------------------------

def test_sync_star_plain_matches_reference_and_run_protocol(inst):
    ref, port = both(inst.A, inst.y, _cfg())
    sync = protocol.run_protocol(inst.A, inst.y, protocol.ProtocolConfig(
        spec=QuantSpec(**SPEC), device="cpu", **_cfg()))
    assert port.history.tobytes() == sync.history.tobytes()
    assert report_core(port.stats) == report_core(sync.stats)


def test_sync_gold_ring_matches_reference(inst):
    ref, port = both(inst.A, inst.y, _cfg(cipher="gold", key_bits=160,
                                          iters=3),
                     topo=("ring", {}))
    assert port.stats["runtime"]["coalesced_ops"] > 0


def test_sync_vec_hierarchical_matches_reference(inst):
    """The fused multi-edge matvec (``c_matvec_many``) on the vec arm."""
    ref, port = both(inst.A, inst.y, _cfg(K=4, cipher="vec", key_bits=128,
                                          iters=3),
                     topo=("hierarchical", dict(fanout=2)))
    rt = port.stats["runtime"]
    assert rt["coalesced_ops"] > 0
    assert sum(rt["link_bytes"].values()) \
        == 2 * sum(port.stats["traffic_bytes"].values())


def test_sync_workload_runtime_matches_reference():
    wl = workloads.get("logistic", rho=1.0, lam=0.1)
    winst = wl.make_instance(24, 24, 4, seed=2)
    spec = wl.calibrate_spec(winst.A, winst.y, 4, 5)
    _, port = both(winst.A, winst.y,
                   dict(K=4, rho=1.0, lam=0.1, iters=5, seed=0,
                        workload="logistic", cipher="plain"),
                   spec=dict(delta=spec.delta, zmin=spec.zmin,
                             zmax=spec.zmax),
                   topo=("hierarchical", dict(fanout=2)),
                   workload=("logistic", dict(rho=1.0, lam=0.1)))
    assert port.stats["workload"] == "logistic"


def test_hierarchical_virtual_clock_matches_reference(inst):
    _, star = both(inst.A, inst.y, _cfg(iters=4))
    _, hier = both(inst.A, inst.y, _cfg(iters=4),
                   topo=("hierarchical", dict(fanout=2)))
    assert hier.stats["runtime"]["virtual_time"] \
        > star.stats["runtime"]["virtual_time"]


# ---------------------------------------------------------------------------
# deadline mode
# ---------------------------------------------------------------------------

def test_deadline_slow_edge_matches_reference(inst):
    _, port = both(inst.A, inst.y, _cfg(
        iters=40, deadline=1.0,
        latency_fn=lambda k, t: 2.0 if (k == 1 and t % 3 == 0) else 0.1))
    assert port.stale_events > 0


def test_deadline_legacy_inline_semantics_match_reference(inst):
    slow = lambda k, t: 2.0 if (k == 1 and t % 2 == 1) else 0.0  # noqa: E731
    _, port = both(inst.A, inst.y, _cfg(iters=6, deadline=1.0,
                                        latency_fn=slow))
    assert port.stale_events == 3


def test_deadline_waits_for_edge_with_no_cache(inst):
    _, port = both(inst.A, inst.y, _cfg(
        iters=1, deadline=0.5,
        latency_fn=lambda k, t: 3.0 if k == 2 else 0.01))
    assert port.stale_events == 0


def test_tiny_deadline_matches_reference(inst):
    _, port = both(inst.A, inst.y, _cfg(iters=30, deadline=1e-6))
    assert port.stale_events > 0
    assert not np.array_equal(port.history[5], port.history[29])


@pytest.mark.parametrize("hold", [0, 16, "auto"])
def test_deadline_hold_coalescing_matches_reference(inst, hold):
    """K=2 with edge1 behind a slow link: held lone ops merge across
    rounds; launches and held flushes equal the reference's."""
    cfg = dict(K=2, lam=0.05, iters=10, cipher="plain", seed=0,
               deadline=0.02, latency_fn=lambda k, t: 0.0)
    _, port = both(inst.A, inst.y, cfg,
                   per_link={("master", "edge1"): dict(latency_s=15e-3)},
                   coalesce_hold_ticks=hold, tick_s=1e-3)
    rt = port.stats["runtime"]
    assert (rt["held_flushes"] > 0) == (hold != 0)
    assert port.stale_events > 0


def test_auto_hold_ticks_zero_on_homogeneous_links(inst):
    _, port = both(inst.A, inst.y, _cfg(iters=3),
                   coalesce_hold_ticks="auto")
    assert port.stats["runtime"]["coalesce_hold_ticks"] == 0
    assert port.stats["runtime"]["held_flushes"] == 0


def test_deadline_gold_straggler_behind_slow_link_matches_reference(inst):
    """Gold arm, a 10x slow edge behind a slow link, hold "auto": stale
    resident ciphertexts substitute for late blocks, and ops of different
    rounds share launches."""
    _, port = both(inst.A, inst.y, _cfg(
        cipher="gold", key_bits=128, iters=4, deadline=0.2,
        latency_fn=lambda k, t: 0.5 if k == 1 else 0.05),
        per_link={("master", "edge1"): dict(latency_s=0.15)},
        coalesce_hold_ticks="auto", tick_s=1e-3, trace=True)
    rt = port.stats["runtime"]
    assert port.stale_events > 0 and rt["held_flushes"] > 0


def test_run_protocol_delegates_deadline_to_runtime(inst):
    cfg = protocol.ProtocolConfig(spec=QuantSpec(**SPEC), device="cpu",
                                  **_cfg(iters=4, deadline=1.0,
                                         latency_fn=lambda k, t: 0.0))
    r = protocol.run_protocol(inst.A, inst.y, cfg)
    assert r.stats["runtime"]["mode"] == "deadline"
    ref = rproto.run_protocol(inst.A, inst.y, rproto.ProtocolConfig(
        spec=RQuantSpec(**SPEC), **_cfg(iters=4, deadline=1.0,
                                        latency_fn=lambda k, t: 0.0)))
    assert_same(ref, r)


# ---------------------------------------------------------------------------
# lossy links, streaming re-shares
# ---------------------------------------------------------------------------

def test_lossy_links_match_reference(inst):
    _, port = both(inst.A, inst.y, _cfg(iters=4, seed=7),
                   link=dict(drop_prob=0.2, timeout_s=2e-3))
    rt = port.stats["runtime"]
    assert rt["retransmits"] > 0
    assert sum(rt["link_bytes"].values()) \
        > sum(port.stats["traffic_bytes"].values())


STREAMING = ("streaming_lasso", dict(rho=1.0, lam=0.05, segments=3,
                                     period=2))


@pytest.fixture(scope="module")
def sinst():
    return make_lasso(24, 24, sparsity=0.1, noise=0.01, seed=1)


def _scfg(**kw):
    return dict(dict(K=3, lam=0.05, iters=6, cipher="plain", seed=0,
                     workload="streaming_lasso"), **kw)


def test_streaming_reshare_matches_reference(sinst):
    _, port = both(sinst.A, sinst.y, _scfg(), workload=STREAMING,
                   topo=("hierarchical", dict(fanout=2)))
    assert port.stats["reshare_events"] == 6


def test_streaming_reshare_under_latency_trace_matches_reference(sinst):
    _, port = both(sinst.A, sinst.y, _scfg(), workload=STREAMING,
                   per_link={("master", "edge1"): dict(latency_s=9e-3)},
                   coalesce_hold_ticks="auto", tick_s=1e-3, trace=True)
    rt = port.stats["runtime"]
    assert rt["coalesce_hold_ticks"] > 0
    assert sum(e[1] == "reshare" for e in rt["trace"]) \
        == port.stats["reshare_events"] > 0


def test_streaming_reshare_survives_jitter_and_drops(sinst):
    _, port = both(sinst.A, sinst.y, _scfg(iters=8), workload=STREAMING,
                   link=dict(jitter_s=2e-3, drop_prob=0.05,
                             timeout_s=5e-3))
    assert port.stats["reshare_events"] == 6
    assert port.stats["runtime"]["retransmits"] > 0


def test_reshare_round_guard_drops_stale_delivery():
    class _Rt:
        cfg = protocol.ProtocolConfig(spec=QuantSpec(**SPEC), device="cpu")

    ea = runner.EdgeActor(0, _Rt())
    msg = lambda t, p: Message(src="master", dst="edge0",  # noqa: E731
                               tag="reshare", payload=(t, p), nbytes=0)
    ea.on_message(msg(4, "segment2"))
    ea.on_message(msg(2, "segment1"))
    assert ea.node.alpha_hat == "segment2"
    ea.on_message(msg(6, "segment3"))
    assert ea.node.alpha_hat == "segment3"


# ---------------------------------------------------------------------------
# churn, recycled updates, health
# ---------------------------------------------------------------------------

def test_churn_span_stream_under_jitter_loss_and_hold(sinst):
    _, port = both(sinst.A, sinst.y, _scfg(iters=8, recycle=True),
                   workload=STREAMING,
                   churn_of=lambda m: m.ChurnSchedule.quarter(3, 8),
                   link=dict(jitter_s=2e-3, drop_prob=0.05,
                             timeout_s=5e-3),
                   coalesce_hold_ticks="auto", tick_s=1e-3, trace=True)
    ch = port.stats["churn"]
    assert ch["leaves"] == ch["rejoins"] == 1
    assert port.stats["reshare_events"] == 4


def test_failed_edge_is_detected_like_the_reference(inst):
    _, port = both(inst.A, inst.y,
                   _cfg(iters=12, deadline=1.0,
                        latency_fn=lambda k, t: 0.0),
                   churn_of=lambda m: m.ChurnSchedule(3, [(2, 0, "fail")]),
                   trace=True)
    ch = port.stats["churn"]
    assert ch["fails"] == ch["deaths"] == 1 and port.stale_events > 0
    assert np.array_equal(port.history[-1, :16], port.history[-2, :16])


def test_rejoin_beats_the_probe_chain_like_the_reference(inst):
    _, port = both(inst.A, inst.y,
                   _cfg(iters=9, deadline=1.0, latency_fn=lambda k, t: 0.0),
                   churn_of=lambda m: m.ChurnSchedule.quarter(3, 9,
                                                              kind="fail"))
    assert port.stats["churn"] == {"leaves": 0, "rejoins": 1, "fails": 1,
                                   "deaths": 0, "recycled": 0}


def test_recycled_updates_match_reference(inst):
    _, full = both(inst.A, inst.y, _cfg(iters=30))
    _, rec = both(inst.A, inst.y, _cfg(iters=30, recycle=True))
    assert rec.history.tobytes() == full.history.tobytes()
    assert rec.stats["churn"]["recycled"] > 0
    assert rec.stats["runtime"]["launches"] \
        < full.stats["runtime"]["launches"]


def test_health_watchers_match_reference(inst):
    """Monitored deadline run with a straggler: the health section (the
    watchers' counters and alerts on the virtual clock) equals the
    reference's."""
    _, port = both(inst.A, inst.y,
                   _cfg(iters=12, deadline=1e-6), health=True, trace=True)
    h = port.stats["runtime"]["health"]
    assert h["counters"]["rounds"] == 12


def test_build_runtime_validation_matches_reference(inst):
    for pkg in PACKAGES:
        P = PACKAGES[pkg]
        kw = {"device": "cpu"} if pkg == "port" else {}
        cfg = P["proto"].ProtocolConfig(spec=P["spec"](**SPEC),
                                        **_cfg(iters=3))
        with pytest.raises(ValueError, match="deadline mode needs"):
            P["run"](inst.A, inst.y, cfg, mode="deadline", **kw)
        fail = dataclasses.replace(cfg, churn=P["churn"].ChurnSchedule(
            3, [(1, 0, "fail")]))
        with pytest.raises(ValueError, match="need deadline mode"):
            P["run"](inst.A, inst.y, fail, **kw)
        with pytest.raises(ValueError, match="topology has"):
            P["run"](inst.A, inst.y, cfg, topology=P["topo"].star(4), **kw)
