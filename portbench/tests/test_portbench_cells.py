"""Every cell through the harness on the CPU at a tiny cut (the port's
plain kernel versions): the program's iterates equal the plain
reference's, and the result line carries its required keys."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from portbench import bench, program
from portbench.reference.admm import lasso_history

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
#: the cells judged by the LASSO reference, and the train cells
TRAIN = [c for c in CELLS
         if hasattr(bench.resolve_cell(c).driver, "judge")]
LASSO = [c for c in CELLS if c not in TRAIN]
#: 8 rows, 8 columns an edge (4 for ten edges), 80-bit keys
TINY = {"fig6_k3": {"M": 8, "N": 24, "key_bits": 80},
        "fig6_k3_n1584": {"M": 8, "N": 24, "key_bits": 80},
        "fig7_k10": {"M": 8, "N": 40, "key_bits": 80}}
#: Yi-9B's reduced() sizes in float32, 2 x 32 tokens a step
TINY_LM = {"config": {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv": 2,
                      "d_ff": 128, "vocab": 256, "dtype": "float32"},
           "params": {"seq": 32}}


def tiny(cell: str) -> dict:
    return {"config": TINY[cell.split(".")[0]],
            "params": {"warmup_rounds": 1, "least_rounds": 2}}


@pytest.mark.parametrize("cell", LASSO)
def test_cell_equals_the_reference(cell):
    result = bench.run_cell(cell, 2 ** 31 + 11, 0.01, False, device="cpu",
                            overrides=tiny(cell))
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "run", "checks"]
    assert result["correct"], result["checks"]
    assert result["failed"] == 0
    assert result["attempted"] == result["run"]["tenant_rounds"] > 0
    assert result["checks"]["history_gap"] == {"value": 0.0, "limit": 0.0}
    units = {m["name"]: m["unit"] for m in BENCH["end_to_end"]
             if cell in m.get("workloads", CELLS)}
    assert {k: v["unit"] for k, v in result["metrics"].items()} == units
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    json.dumps(result)


@pytest.mark.parametrize("cell", TRAIN)
def test_train_cell_equals_the_reference(cell, capsys):
    """At Yi-9B's reduced() sizes in float32 the program's warm-up steps
    equal the reference's to float32 rounding: every number far under
    the cell's limits, every window step's loss finite."""
    result = bench.run_cell(cell, 2 ** 31 + 11, 0.2, False, device="cpu",
                            overrides=TINY_LM)
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "run", "checks"]
    checks = result["checks"]
    assert result["correct"] and result["failed"] == 0, checks
    assert list(checks) == ["loss_gap", "grad_gap", "change_gap",
                            "losses_nonfinite", "steps_missing"]
    for name in ("loss_gap", "grad_gap", "change_gap"):
        assert checks[name]["value"] < 1e-4 * checks[name]["limit"] + 1e-5
    assert result["attempted"] == 3 + result["run"]["steps"]
    assert result["run"]["tokens"] == result["run"]["steps"] * 2 * 32
    units = {m["name"]: m["unit"] for m in BENCH["end_to_end"]
             if cell in m.get("workloads", CELLS)}
    assert {k: v["unit"] for k, v in result["metrics"].items()} == units
    assert all(v["value"] > 0 for v in result["metrics"].values())
    err = capsys.readouterr().err.strip().splitlines()
    assert [line.split()[0] for line in err[-5:]] == list(checks)
    json.dumps(result)


def test_reference_equals_the_plain_arm_at_the_cells_size():
    """At fig6_k3's own size the reference equals the port's exact
    plaintext arm (``cipher="plain"``) bit for bit, over rounds whose
    iterates move."""
    from repro_torch.core import protocol
    config = json.loads((ROOT / "portbench/configs/fig6_k3.json")
                        .read_text())
    A, y = program.inputs(config, 123)
    cfg = program.protocol_config({**config, "cipher": "plain"}, seed=123,
                                  iters=6, device="cpu")
    got = protocol.run_protocol(A, y, cfg).history
    want, bits = lasso_history(
        A, y, K=config["K"], rho=config["rho"], lam=config["lam"],
        delta=config["delta"], zmin=config["zmin"], zmax=config["zmax"],
        rounds=6)
    assert np.array_equal(got, want)
    assert np.abs(np.diff(want, axis=0)).max() > 0
    assert bits == 33


def test_tenants_get_inputs_of_their_own():
    config = json.loads((ROOT / "portbench/configs/fig6_k3.json")
                        .read_text())
    (A0, y0), (A1, _) = (program.inputs(config, s) for s in (5, 6))
    A0b, y0b = program.inputs(config, 5)
    assert np.array_equal(A0, A0b) and np.array_equal(y0, y0b)
    assert not np.array_equal(A0, A1)


def test_run_without_the_program_or_a_card_prints_no_result(tmp_path):
    """In a directory with only BENCHMARK.json and portbench/, and with
    no card, the command exits non-zero and prints nothing on stdout."""
    import shutil
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for cwd, why in ((tmp_path, "repro_torch"), (ROOT, "card")):
        proc = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload",
             "fig7_k10.solo", "--seed", "1", "--seconds", "1", "--trace",
             "0"], cwd=cwd, capture_output=True, text=True, timeout=300,
            env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
                 "HOME": str(tmp_path)})
        assert proc.returncode != 0
        assert proc.stdout.strip() == ""
        assert why in proc.stderr
