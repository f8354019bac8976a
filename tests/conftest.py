import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_subprocess(code: str, devices: int = 4, timeout: int = 600):
    """Run ``code`` in a fresh interpreter with N host platform devices.

    Tests that need a multi-device mesh use this so the main test process
    keeps the default single-device view (the dry-run is the only entry
    point allowed to pin 512 devices).
    """
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, timeout=timeout,
                       env=env, cwd=REPO)
    if r.returncode != 0:
        raise AssertionError(
            f"subprocess failed (rc={r.returncode})\n--- stdout\n"
            f"{r.stdout}\n--- stderr\n{r.stderr[-4000:]}")
    return r.stdout


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips inside the test without one")


@pytest.fixture
def subproc():
    return run_subprocess


@pytest.fixture(autouse=True, scope="session")
def _ledger_to_tmp(tmp_path_factory):
    """Point the run-history ledger (repro.obs.ledger) at a session tmp
    file so the ~350 protocol runs in the suite never pollute the user's
    ``~/.cache/repro/ledger.jsonl``.  Tests that exercise the ledger
    explicitly set their own ``REPRO_LEDGER`` via monkeypatch."""
    if "REPRO_LEDGER" not in os.environ:
        os.environ["REPRO_LEDGER"] = str(
            tmp_path_factory.mktemp("ledger") / "ledger.jsonl")
    yield
