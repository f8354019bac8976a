"""The port's ``workload_zoo`` example against the reference, on the CPU.

The reference script runs 30 iterations of every family (more than 100 s
of CPU on its first family alone), so its loop body is reproduced here
with the reference's API at 2 iterations, family by family, against the
port's ``repro_torch.examples.workload_zoo.run_family`` (the same body,
called by the port's ``main``).  With zero tolerance: the printed row
(objectives, gaps, metrics), the private solution and the history; the
gold history also equals the plain integer chain.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro import workloads as ref_workloads
from repro.core import protocol as ref_protocol
from repro.workloads.base import simulate_float as ref_simulate_float
from repro_torch import workloads
from repro_torch.core import protocol
from repro_torch.examples import workload_zoo

torch.set_num_threads(1)

ITERS = 2
M, N, K = workload_zoo.M, workload_zoo.N, workload_zoo.K


def reference_row(name: str, iters: int) -> dict:
    """The reference script's loop body for one family."""
    wl = ref_workloads.get_default(name)
    inst = wl.make_instance(M, N, K, seed=0)
    spec = wl.calibrate_spec(inst.A, inst.y, K, iters)
    cfg = ref_protocol.ProtocolConfig(K=K, rho=wl.rho, lam=wl.lam,
                                      iters=iters, spec=spec, cipher="gold",
                                      key_bits=256, seed=0, workload=name)
    r = ref_protocol.run_protocol(inst.A, inst.y, cfg, workload=wl)
    xf, _ = ref_simulate_float(wl, inst.A, inst.y, K, iters)
    ref = wl.reference_solution(inst.A, inst.y, K)
    gap_q = float(np.max(np.abs(r.x - xf)))
    gap_c = float(np.max(np.abs(wl.fold_solution(xf, K) - ref)))
    mets = {k: round(v, 4) for k, v in wl.metrics(inst, r.x).items()
            if k != "objective"}
    line = (f"{name:<12} {wl.objective(inst.A, inst.y, r.x):>13.5f} "
            f"{wl.objective(inst.A, inst.y, xf):>11.5f} {gap_q:>18.2e} "
            f"{gap_c:>15.2e}  {mets}")
    return {"result": r, "line": line}


def test_every_family_is_in_the_zoo():
    assert workloads.names() == ref_workloads.names()


@pytest.mark.parametrize("name", ref_workloads.names())
def test_family_row_equals_reference(name):
    want = reference_row(name, ITERS)
    got = workload_zoo.run_family(name, iters=ITERS, device="cpu")
    assert got["line"] == want["line"]
    assert np.array_equal(got["result"].x, want["result"].x)
    assert got["result"].history.tobytes() == \
        want["result"].history.tobytes()
    assert got["gap_q"] < 1e-2
    plain = protocol.run_protocol(
        got["inst"].A, got["inst"].y,
        dataclasses.replace(got["cfg"], cipher="plain"),
        workload=got["workload"])
    assert plain.history.tobytes() == got["result"].history.tobytes()


def test_header_is_the_reference_header(capsys, monkeypatch):
    """``main`` prints the reference's header, one row per family and the
    closing line (rows stubbed here; each is pinned above)."""
    monkeypatch.setattr(workload_zoo, "run_family", lambda name, **kw: {
        "line": name, "gap_q": 0.0})
    workload_zoo.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == (f"{'workload':<12} {'obj(private)':>13} "
                      f"{'obj(float)':>11} {'|x_priv - x_float|':>18} "
                      f"{'|x_float - ref|':>15}  metrics")
    assert out[1:-1] == workloads.names()
    assert out[-1].startswith("OK — every family ran privately")
