"""The schema-versioned ``RunReport`` and the profiling event log.

Port of the RunReport core of ``repro.obs.metrics``: the protocol driver
builds ``ProtocolResult.stats`` through :func:`build_run_report`, and
:func:`report_core` is the driver-independent view the conformance tests
compare between the two packages.
"""
from __future__ import annotations

import numpy as np

#: RunReport schema version (the reference's)
REPORT_SCHEMA_VERSION = 1

#: sections that are identical between drivers and packages for one run
CORE_SECTIONS = ("schema_version", "workload", "cipher", "key_bits",
                 "ops", "traffic_bytes", "reshare_events", "churn",
                 "mse_trajectory")

#: the ``churn`` section's fixed key set (all ints)
CHURN_KEYS = ("leaves", "rejoins", "fails", "deaths", "recycled")

_profile_events: list[dict] = []
_profile_dropped = 0

#: bound on the process-global log; overflow drops the OLDEST events and
#: is announced by a ``profile_overflow`` marker in the next snapshot
PROFILE_LOG_CAP = 4096


def record_profile(kind: str, **fields) -> None:
    """Append one profiling event (warmup, kernel build) to the
    process-global log."""
    global _profile_dropped
    if len(_profile_events) >= PROFILE_LOG_CAP:
        del _profile_events[0]
        _profile_dropped += 1
    _profile_events.append({"kind": kind, **fields})


def profile_snapshot(clear: bool = False) -> list[dict]:
    """The profiling events recorded so far (optionally draining them)."""
    global _profile_dropped
    out = [dict(e) for e in _profile_events]
    if _profile_dropped:
        out.append({"kind": "profile_overflow",
                    "dropped": _profile_dropped, "cap": PROFILE_LOG_CAP})
    if clear:
        _profile_events.clear()
        _profile_dropped = 0
    return out


def mse_trajectory(history: np.ndarray) -> list[float]:
    """Per-round mean-square distance of the iterate to the run's final
    iterate — the convergence curve of the paper's MSE plots."""
    h = np.asarray(history, dtype=np.float64)
    if h.ndim != 2 or h.shape[0] == 0:
        return []
    final = h[-1]
    return [float(v) for v in np.mean((h - final[None, :]) ** 2, axis=1)]


def build_run_report(*, driver: str, ops: dict, traffic: dict,
                     key_bits: int | None, cipher: str, workload: str,
                     reshare_events: int, history: np.ndarray,
                     churn: dict | None = None,
                     runtime: dict | None = None) -> dict:
    """Assemble the schema-versioned stats dict for one protocol run.

    Every build drains the process-global profiling log into
    ``runtime["profile"]`` when a runtime section is given, and discards
    it otherwise.
    """
    profile = profile_snapshot(clear=True)
    if runtime is not None and "profile" not in runtime:
        runtime["profile"] = profile
    churn = churn or {}
    report = {
        "schema_version": REPORT_SCHEMA_VERSION,
        "driver": driver,
        "ops": ops,
        "traffic_bytes": {k: int(v) for k, v in sorted(traffic.items())},
        "key_bits": key_bits,
        "cipher": cipher,
        "workload": workload,
        "reshare_events": int(reshare_events),
        "churn": {k: int(churn.get(k, 0)) for k in CHURN_KEYS},
        "mse_trajectory": mse_trajectory(history),
    }
    if runtime is not None:
        report["runtime"] = runtime
    return report


def report_core(report: dict) -> dict:
    """The driver-independent sections of a RunReport (conformance view)."""
    return {k: report[k] for k in CORE_SECTIONS if k in report}
