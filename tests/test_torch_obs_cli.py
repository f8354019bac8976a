"""repro_torch's ``obs.report`` and ``obs.sentinel`` CLIs vs the reference's.

The same inputs go to both packages' ``main``: a chrome trace with an
embedded RunReport (from the port's event-driven runtime, traced and
health-monitored), the trace ``serve_sim --trace`` writes, bare RunReport
JSON files for the A/B diff (identical cores and differing ones), and
ledger files of run and bench records (clean, correctness drift, perf and
convergence regressions, a first run, an empty and a disabled ledger).
The printed text, the ``--json`` documents and the exit codes must be
equal.
"""
import copy
import json

import pytest
import torch

from repro.obs import report as rreport
from repro.obs import sentinel as rsentinel
from repro_torch.core import protocol
from repro_torch.core.quantization import QuantSpec
from repro_torch.data.synthetic import make_lasso
from repro_torch.launch import serve_sim
from repro_torch.obs import chrome_trace
from repro_torch.obs import ledger
from repro_torch.obs import report
from repro_torch.obs import sentinel
from repro_torch.obs import trace as trace_mod
from repro_torch.runtime.runner import run_on_runtime

torch.set_num_threads(1)


def _both(capsys, port_main, ref_main, argv):
    """(exit code, stdout) of each package's CLI on the same argv."""
    out = {}
    for name, main in (("port", port_main), ("ref", ref_main)):
        rc = main(list(argv))
        out[name] = (rc, capsys.readouterr().out)
    return out["port"], out["ref"]


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """A traced, health-monitored gold run on the CPU: its trace file,
    its bare report, and a second report whose core differs."""
    d = tmp_path_factory.mktemp("obs")
    inst = make_lasso(24, 32, sparsity=0.1, noise=0.01, seed=1)
    cfg = protocol.ProtocolConfig(K=4, lam=0.05, iters=3, seed=0,
                                  key_bits=128, cipher="gold",
                                  spec=QuantSpec(1e6, -8.0, 8.0))
    tracer = trace_mod.Tracer()
    res = run_on_runtime(inst.A, inst.y, cfg, trace=tracer, health=True,
                         device="cpu")
    paths = {"trace": str(d / "run.trace.json"),
             "a": str(d / "a.json"), "b": str(d / "b.json"),
             "c": str(d / "c.json")}
    chrome_trace.write(paths["trace"], tracer, run_report=res.stats)
    report_doc = json.loads(json.dumps(res.stats, default=float))
    other = copy.deepcopy(report_doc)
    other["traffic_bytes"]["edge->master"] += 1
    other["runtime"]["virtual_time"] *= 2
    for key, doc in (("a", report_doc), ("b", report_doc), ("c", other)):
        with open(paths[key], "w") as f:
            json.dump(doc, f)
    return paths


@pytest.mark.parametrize("json_flag", ([], ["--json"]))
def test_report_summary_matches_reference(traced, capsys, json_flag):
    for path in (traced["trace"], traced["a"]):
        port, ref = _both(capsys, report.main, rreport.main,
                          [path] + json_flag)
        assert port == ref and port[0] == 0
        assert "coalesce" in port[1]


@pytest.mark.parametrize("json_flag", ([], ["--json"]))
@pytest.mark.parametrize("pair, rc", [(("a", "b"), 0), (("a", "c"), 1),
                                      (("trace", "a"), 0)])
def test_report_diff_matches_reference(traced, capsys, json_flag, pair, rc):
    port, ref = _both(capsys, report.main, rreport.main,
                      [traced[pair[0]], traced[pair[1]]] + json_flag)
    assert port == ref and port[0] == rc


def test_report_of_a_serve_trace_matches_reference(tmp_path, capsys):
    path = str(tmp_path / "serve.trace.json")
    serve_sim.main(["--tenants", "2", "--iters", "2", "--edges", "2",
                    "--block", "8", "--trace", path, "--device", "cpu"])
    capsys.readouterr()
    for flag in ([], ["--json"]):
        port, ref = _both(capsys, report.main, rreport.main, [path] + flag)
        assert port == ref and port[0] == 0
    doc = json.loads(port[1])
    assert doc["kind"] == "summary" and doc["spans"] > 0


def test_report_usage_errors_match_reference(traced, capsys):
    for main in (report.main, rreport.main):
        with pytest.raises(SystemExit) as exc:
            main([traced["a"]] * 3)
        assert exc.value.code == 2
    capsys.readouterr()


# ---------------------------------------------------------------------------
# sentinel
# ---------------------------------------------------------------------------

def _run_record(i, **over):
    rec = {"v": 1, "kind": "run", "ts": 1000.0 + i, "seq": i,
           "driver": "serve", "workload": "lasso", "cipher": "gold",
           "K": 3, "key_bits": 2048, "seed": 0, "iters": 2, "mode": "sync",
           "core_sig": "0123456789abcdef", "rounds": 2,
           "mse_round0": 1.0 + 0.01 * i, "mse_mid": 0.5,
           "rounds_per_sec": 10.0 + 0.1 * i,
           "warm_launch_wall_ms": {"matvec": {"p50": 1.0 + 0.01 * i,
                                              "p95": 1.2}}}
    rec.update(over)
    return rec


LEDGERS = {
    "clean": [_run_record(i) for i in range(5)],
    "first_run": [_run_record(0)],
    "drift": [_run_record(i) for i in range(4)]
    + [_run_record(4, core_sig="fedcba9876543210")],
    "perf": [_run_record(i) for i in range(4)]
    + [_run_record(4, warm_launch_wall_ms={"matvec": {"p50": 9.0,
                                                      "p95": 9.5}},
                   rounds_per_sec=1.0)],
    "convergence": [_run_record(i) for i in range(4)]
    + [_run_record(4, mse_round0=50.0, mse_mid=40.0)],
    "other_config": [_run_record(i) for i in range(3)]
    + [_run_record(3, seed=7, core_sig="fedcba9876543210")],
    "bench": [{"v": 1, "kind": "bench", "ts": 1.0 + i, "seq": i,
               "bench": "serve", "name": "row", "us_per_call": u,
               "derived": ""} for i, u in enumerate((100, 102, 98, 900))],
    "empty": [],
}


def _write_ledger(path, records):
    with open(path, "w") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")
        f.write("not json\n")                    # corrupt lines are skipped


@pytest.mark.parametrize("json_flag", ([], ["--json"]))
@pytest.mark.parametrize("name, rc", [
    ("clean", 0), ("first_run", 0), ("drift", 1), ("perf", 1),
    ("convergence", 1), ("other_config", 0), ("bench", 1), ("empty", 0)])
def test_sentinel_matches_reference(tmp_path, capsys, json_flag, name, rc):
    path = str(tmp_path / "ledger.jsonl")
    _write_ledger(path, LEDGERS[name])
    port, ref = _both(capsys, sentinel.main, rsentinel.main,
                      ["--ledger", path] + json_flag)
    assert port == ref and port[0] == rc
    if json_flag and name == "drift":
        checks = {f["check"] for f in json.loads(port[1])["findings"]}
        assert checks == {"correctness"}


def test_sentinel_knobs_and_disabled_ledger_match_reference(
        tmp_path, capsys, monkeypatch):
    path = str(tmp_path / "ledger.jsonl")
    _write_ledger(path, LEDGERS["perf"])
    for argv in (["--ratio", "20"], ["--last", "1"]):
        port, ref = _both(capsys, sentinel.main, rsentinel.main,
                          ["--ledger", path] + argv)
        assert port == ref
    monkeypatch.setenv("REPRO_LEDGER", "off")
    for main in (sentinel.main, rsentinel.main):
        assert main([]) == 2
    capsys.readouterr()


def test_sentinel_reads_the_ports_own_run_records(tmp_path, capsys,
                                                  monkeypatch):
    """Two identical served runs recorded by the port's ledger: the
    newest has a baseline of one with the same core signature."""
    path = str(tmp_path / "ledger.jsonl")
    monkeypatch.setenv("REPRO_LEDGER", path)
    for _ in range(2):
        serve_sim.main(["--tenants", "1", "--iters", "2", "--edges", "2",
                        "--block", "8", "--device", "cpu"])
    capsys.readouterr()
    records = ledger.load(path)
    assert [r["driver"] for r in records] == ["serve", "serve"]
    assert records[0]["tenant"] == "t0"
    assert records[0]["core_sig"] == records[1]["core_sig"]
    port, ref = _both(capsys, sentinel.main, rsentinel.main,
                      ["--ledger", path, "--json"])
    assert port == ref
    doc = json.loads(port[1])
    assert doc["baseline_n"] == 1
    assert not [f for f in doc["findings"] if f["check"] == "correctness"]
