"""The benchmark's files against the rules they keep, on the CPU: names and
units, every cell's files found by name, the import rules, the roofline
count's independence of the body, and that a new configuration, traffic
mix and metric need new files and entries only."""
from __future__ import annotations

import ast
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import bench, counts, spans

ROOT = Path(__file__).resolve().parents[2]
PB = ROOT / "portbench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_names_and_units():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_line(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) \
            and _line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("portbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and _line(w["why"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
    for m in METRICS:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for entries in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in entries]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert {w["config"] for w in BENCH["workloads"]} \
        == {c["name"] for c in BENCH["configs"]}


def test_every_cell_reports_its_metrics():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    assert next(m for m in BENCH["end_to_end"]
                if m["name"] == "setup_s")["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        moved = next(x for x in BENCH["end_to_end"] if x["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", CELLS))
    for cell in CELLS:
        mine = [m["name"] for m in BENCH["end_to_end"]
                if cell in m.get("workloads", CELLS)]
        assert "setup_s" in mine and len(mine) >= 2
        assert any(cell in m.get("workloads", CELLS)
                   for m in BENCH["per_layer"])


#: what a configuration file holds: a LASSO deployment's, a model's
LASSO_KEYS = ("M", "N", "K", "key_bits", "delta", "rho", "lam", "zmin",
              "zmax")
MODEL_KEYS = ("family", "n_layers", "d_model", "n_heads", "n_kv", "d_ff",
              "vocab", "rope_theta", "norm_eps", "dtype", "remat",
              "reference", "optimizer", "limits")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    found = bench.resolve_cell(cell)
    assert hasattr(found.driver, "Driver")
    keys = MODEL_KEYS if hasattr(found.driver, "judge") else LASSO_KEYS
    for key in keys + ("source", "reduced", "assumed", "published"):
        assert key in found.config
    entry = next(c for c in BENCH["configs"]
                 if c["name"] == found.config["name"])
    assert sorted(found.config["reduced"]) == sorted(entry["reduced"])
    for key, value in found.config["published"].items():
        assert (found.config[key] != value) == (key in entry["reduced"]), key
    for m in found.end_to_end + found.per_layer:
        assert callable(bench.reader(ROOT, m["name"]))


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_jax_and_a_reference_apart_from_the_program():
    for path in PB.rglob("*.py"):
        assert not _imports(path) & set(bench.FORBIDDEN), path
    for path in (PB / "reference").rglob("*.py"):
        assert _imports(path) <= {"__future__", "math", "numpy", "torch"}, \
            path


def test_the_program_loads_no_jax():
    """The port and the harness import no JAX; the check run.py makes
    before it prints a result finds the JAX package once it is loaded."""
    code = ("from portbench import bench, counts, program, spans, trace; "
            "import repro_torch.core.protocol, repro_torch.runtime.runner, "
            "repro_torch.serve.protocol_engine, repro_torch.train.loop; "
            "spans.labels(); [spans.resolve(t) for t in spans.TARGETS]; "
            "assert not bench.forbidden_modules(); "
            "import repro; assert 'repro' in bench.forbidden_modules()")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_span_targets_exist():
    for target in spans.TARGETS:
        spans.resolve(target)


def test_roofline_count_is_the_same_for_every_body():
    from repro_torch.kernels import geometry
    by_fn: dict = {}
    for body in geometry.BODIES:
        by_fn.setdefault(counts.function_of(body), []).append(body)
    assert set(by_fn) == set(counts.FUNCTIONS)
    inputs = dict(nk=192, key_bits=2048, code_bits=33)
    for fn, bodies in by_fn.items():
        for B, k in ((192, 64), (36_864, 64), (4_608, 128)):
            got = {body: counts.least_seconds_of({(body, B, k): 3},
                                                 **inputs)
                   for body in bodies}
            assert len({json.dumps(v) for v in got.values()}) == 1, got
            assert got[bodies[0]][fn] > 0


@pytest.mark.parametrize("function,B,k,exp_bits,factors,ms", [
    # bounds of chip_smoke.py's kernel table (PERF.md), where its body's
    # own count is the least: Montgomery ladders, the REDC tree
    ("modexp_fixed", 192, 64, 2048, 0, 0.3928),
    ("modexp", 36_864, 64, 64, 0, 2.903),
    ("modexp_rows", 442_368, 128, 64, 0, 138.46),
    ("prod_rows", 192, 128, 0, 192, 0.1440),
])
def test_counts_agree_with_the_kernel_table(function, B, k, exp_bits,
                                            factors, ms):
    work, nbytes = counts.launch_work(function, B, k, exp_bits=exp_bits,
                                      factors=factors)
    assert counts.least_seconds(work, nbytes) * 1e3 \
        == pytest.approx(ms, rel=2e-3)


def test_new_files_and_entries_extend_the_benchmark(tmp_path):
    """A configuration, a traffic mix and a per-layer metric, each added
    as a file and an entry in a copy, run without an edit to any file
    the copy already had: a LASSO deployment, and a dense model (Yi-9B's
    reduced() sizes) trained by the train driver on a mix of its own."""
    shutil.copytree(PB, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    copy = json.loads(json.dumps(BENCH))
    cfg = json.loads((PB / "configs" / "fig6_k3.json").read_text())
    cfg.update(name="dummy_cfg", M=8, N=24, key_bits=80)
    (tmp_path / "portbench/configs/dummy_cfg.json").write_text(
        json.dumps(cfg))
    (tmp_path / "portbench/traffic/dummy_mix.json").write_text(json.dumps(
        {"driver": "protocol", "why": "a dummy",
         "params": {"warmup_rounds": 1, "least_rounds": 2}}))
    (tmp_path / "portbench/metrics/dummy_metric.py").write_text(
        "def read(run):\n    return run.rounds\n")
    copy["configs"].append({"name": "dummy_cfg", "source": "a dummy",
                            "file": "portbench/configs/dummy_cfg.json",
                            "reduced": [], "why": "a dummy"})
    copy["workloads"].append({"name": "dummy_cfg.dummy_mix",
                              "config": "dummy_cfg", "traffic": "dummy_mix",
                              "chips": 1, "why": "a dummy"})
    copy["per_layer"].append({"name": "dummy_metric", "unit": "rounds",
                              "better": "higher", "source": "host_clock",
                              "layer": "drivers", "moves": "setup_s",
                              "workloads": ["dummy_cfg.dummy_mix"]})
    lm_cfg = json.loads((PB / "configs" / "yi9b_d8.json").read_text())
    lm_cfg.update(name="tiny_lm", n_layers=2, d_model=64, n_heads=4, n_kv=2,
                  d_ff=128, vocab=256, dtype="float32")
    (tmp_path / "portbench/configs/tiny_lm.json").write_text(
        json.dumps(lm_cfg))
    (tmp_path / "portbench/traffic/tiny_train.json").write_text(json.dumps(
        {"driver": "train", "why": "a dummy",
         "params": {"batch": 2, "seq": 16, "warmup_steps": 3,
                    "least_steps": 2}}))
    copy["configs"].append({"name": "tiny_lm", "source": "a dummy",
                            "file": "portbench/configs/tiny_lm.json",
                            "reduced": [], "why": "a dummy"})
    copy["workloads"].append({"name": "tiny_lm.tiny_train",
                              "config": "tiny_lm", "traffic": "tiny_train",
                              "chips": 1, "why": "a dummy"})
    for m in copy["end_to_end"]:
        if "yi9b_d8.train" in m.get("workloads", ()):
            m["workloads"].append("tiny_lm.tiny_train")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(copy))
    lm = bench.run_cell("tiny_lm.tiny_train", 9, 0.05, False,
                        root=tmp_path, device="cpu")
    assert lm["correct"] and list(lm["metrics"]) == [
        "setup_s", "train_tokens_per_s", "mfu"], lm["checks"]
    cell = bench.resolve_cell("dummy_cfg.dummy_mix", root=tmp_path)
    assert [m["name"] for m in cell.per_layer] == ["dummy_metric"]
    assert [m["name"] for m in cell.end_to_end] == ["setup_s"]
    result = bench.run_cell("dummy_cfg.dummy_mix", 7, 0.01, False,
                            root=tmp_path, device="cpu")
    assert result["correct"] and list(result["metrics"]) == ["setup_s"]
    run = bench.RunRecord(tenants=1, rounds=2, laps=[1.0, 1.0],
                          window_s=2.0, setup_s=1.0, launches={},
                          shape_launches={}, serve=None, trace=None,
                          inputs={})
    assert bench._metrics(cell.per_layer, run, tmp_path, required=False) \
        == {"dummy_metric": {"value": 2.0, "unit": "rounds"}}
    for rel, data in before.items():
        assert (tmp_path / rel).read_bytes() == data, rel
