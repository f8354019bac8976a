"""The port's protocol examples against the reference's scripts, on the CPU.

Each reference script (``examples/<name>.py``) runs whole as a
subprocess while the port's ``repro_torch.examples.<name>.main(["--device",
"cpu"])`` runs here on the same seeds; the printed lines must be equal,
with zero tolerance: MSE, gaps, op counts, traffic, virtual times, stale
events, retransmits, AUROC/AUPRC.  The reference's
``edge_network_sim.py`` ends without a line of its own; the port's adds
``OK``.  (``workload_zoo`` is in ``tests/test_torch_examples_zoo.py``.)

Also here: the port's ``auroc``/``auprc`` against the reference's
benchmark helpers, and an example asked for the card on a machine
without one exits with ``resolve_device``'s message.
"""
import contextlib
import dataclasses
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import protocol
from repro_torch.examples import (edge_network_sim,
                                  power_grid_reconstruction, quickstart)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def start_reference(script: str) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(REPO, "src"), REPO]), JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, os.path.join("examples", script)],
                            cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def reference_lines(proc: subprocess.Popen, timeout=900) -> list[str]:
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-4000:]
    return out.splitlines()


def run_both(module, script):
    """(the port's result, its printed lines, the reference's lines); the
    reference runs beside the port's main."""
    ref = start_reference(script)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            res = module.main(["--device", "cpu"])
    finally:
        want = reference_lines(ref)
    return res, buf.getvalue().splitlines(), want


@pytest.fixture(scope="module")
def quickstart_run():
    return run_both(quickstart, "quickstart.py")


def test_quickstart_prints_the_reference_results(quickstart_run):
    _, got, want = quickstart_run
    assert got == want and got[-1] == "OK"


def test_quickstart_gold_history_equals_plain_arm(quickstart_run):
    """The quickstart's gold history equals the plain integer chain."""
    res = quickstart_run[0]
    plain = protocol.run_protocol(res.inst.A, res.inst.y,
                                  dataclasses.replace(res.cfg,
                                                      cipher="plain"))
    assert res.history.tobytes() == plain.history.tobytes()


@pytest.mark.parametrize("module, script, extra", [
    (edge_network_sim, "edge_network_sim.py", ["OK"]),
    (power_grid_reconstruction, "power_grid_reconstruction.py", []),
], ids=["edge_network_sim", "power_grid_reconstruction"])
def test_example_prints_the_reference_results(module, script, extra):
    _, got, want = run_both(module, script)
    assert got == want + extra
    assert got[-1] == "OK"


def test_auroc_auprc_equal_reference():
    from benchmarks.common import auroc, auprc
    rng = np.random.default_rng(0)
    labels = rng.random(300) < 0.2
    scores = np.round(rng.random(300) + labels * 0.3, 2)   # with ties
    assert power_grid_reconstruction.auroc(labels, scores) == \
        auroc(labels, scores)
    assert power_grid_reconstruction.auprc(labels, scores) == \
        auprc(labels, scores)
    assert np.isnan(power_grid_reconstruction.auroc(labels[:0] | True,
                                                    scores[:0]))


@pytest.mark.parametrize("module", [quickstart, edge_network_sim,
                                    power_grid_reconstruction],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_card_without_card_exits(module, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="is_available"):
        module.main([])
