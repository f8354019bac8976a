"""The schema-versioned ``RunReport`` and the profiling event log.

Port of ``repro.obs.metrics``: both drivers (``core.protocol.run_protocol``
and ``runtime.runner.run_on_runtime``) build ``ProtocolResult.stats``
through :func:`build_run_report`; :func:`report_core`,
:func:`reports_equal_modulo_timing`, :func:`diff_reports` and
:func:`validate_report_core` are the conformance surface;
:func:`summary` / :class:`Histogram` the latency-distribution helpers
(the coalescing queue's launch walls) and :class:`Registry` a set of
named counters, gauges and histograms; :data:`PROCESS` is the process's
own, always on, which counts the waits on the card by site
(``obs.trace.wait``).
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


def summary(values) -> dict:
    """``{n, min, max, mean, p50, p95, p99}`` for a sample list."""
    vals = np.asarray(list(values), dtype=np.float64)
    if vals.size == 0:
        return {"n": 0}
    p50, p95, p99 = np.percentile(vals, (50, 95, 99))
    return {"n": int(vals.size), "min": float(vals.min()),
            "max": float(vals.max()), "mean": float(vals.mean()),
            "p50": float(p50), "p95": float(p95), "p99": float(p99)}


class Histogram:
    """Append-only sample collector with a percentile summary."""

    def __init__(self):
        self.values: list[float] = []

    def add(self, v: float) -> None:
        self.values.append(float(v))

    def summary(self) -> dict:
        return summary(self.values)

    def __len__(self) -> int:
        return len(self.values)


class Registry:
    """Named counters / gauges / histograms for one run."""

    def __init__(self):
        self.counters: dict[str, int] = {}
        self.gauges: dict[str, float] = {}
        self.hists: dict[str, Histogram] = {}

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def gauge(self, name: str, v: float) -> None:
        self.gauges[name] = float(v)

    def hist(self, name: str) -> Histogram:
        return self.hists.setdefault(name, Histogram())

    def snapshot(self) -> dict:
        return {"counters": dict(sorted(self.counters.items())),
                "gauges": dict(sorted(self.gauges.items())),
                "histograms": {k: h.summary()
                               for k, h in sorted(self.hists.items())}}

    def since(self, before: dict, prefix: str = "") -> dict:
        """The counters named ``prefix...`` that grew since ``before`` (an
        earlier ``dict(counters)``), by how much."""
        return {k: v - before.get(k, 0)
                for k, v in sorted(self.counters.items())
                if k.startswith(prefix) and v > before.get(k, 0)}


#: the process's counters: ``wait.<site>`` is the number of times the
#: program blocked on the card at that site (``obs.trace.WAITS``);
#: ``exps.int64`` and ``exps.reduced`` the per-element exponents of the
#: batched CRT ModExp uploaded as int64 and split into limbs on the
#: device, or reduced mod phi(p^2) and phi(q^2) and packed on the host
PROCESS = Registry()


_profile_events: list[dict] = []
_profile_dropped = 0

#: bound on the process-global log; overflow drops the OLDEST events and
#: is announced by a ``profile_overflow`` marker in the next snapshot
PROFILE_LOG_CAP = 4096


def record_profile(kind: str, **fields) -> None:
    """Append one profiling event (warmup, calibration, kernel build) to
    the process-global log."""
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


def reports_equal_modulo_timing(a: dict, b: dict) -> bool:
    """True when two RunReports agree on every core section — the
    sync-mode conformance predicate (timing/telemetry sections ignored)."""
    return report_core(a) == report_core(b)


def diff_reports(a: dict, b: dict, label_a: str = "A",
                 label_b: str = "B") -> list[str]:
    """Human-readable core-section differences between two reports."""
    lines = []
    for key in CORE_SECTIONS:
        va, vb = a.get(key), b.get(key)
        if va == vb:
            continue
        if key == "mse_trajectory" and va and vb:
            lines.append(f"mse_trajectory: final {label_a}={va[-1]:.3e} "
                         f"{label_b}={vb[-1]:.3e} (len {len(va)}/{len(vb)})")
        elif isinstance(va, dict) and isinstance(vb, dict):
            for sub in sorted(set(va) | set(vb)):
                if va.get(sub) != vb.get(sub):
                    lines.append(f"{key}.{sub}: {label_a}={va.get(sub)} "
                                 f"{label_b}={vb.get(sub)}")
        else:
            lines.append(f"{key}: {label_a}={va} {label_b}={vb}")
    return lines


def validate_report_core(report: dict, where: str = "report") -> list[str]:
    """Schema errors (empty list = valid) for a RunReport / its core."""
    errors = []
    if not isinstance(report, dict):
        return [f"{where}: not a dict"]
    if report.get("schema_version") != REPORT_SCHEMA_VERSION:
        errors.append(f"{where}: schema_version "
                      f"{report.get('schema_version')!r} != "
                      f"{REPORT_SCHEMA_VERSION}")
    for key, typ in (("ops", dict), ("traffic_bytes", dict),
                     ("mse_trajectory", list), ("workload", str),
                     ("cipher", str)):
        if not isinstance(report.get(key), typ):
            errors.append(f"{where}: missing/ill-typed {key!r}")
    if isinstance(report.get("ops"), dict):
        for ph, ops in report["ops"].items():
            if not isinstance(ops, dict) or not all(
                    isinstance(v, int) for v in ops.values()):
                errors.append(f"{where}: ops[{ph!r}] not a str->int dict")
    # "churn" joined the core sections after schema v1 artifacts were
    # committed: validated when present, not required
    if "churn" in report:
        ch = report["churn"]
        if not isinstance(ch, dict) or not all(
                k in ch and isinstance(ch[k], int) for k in CHURN_KEYS):
            errors.append(f"{where}: churn section must carry int "
                          f"{'/'.join(CHURN_KEYS)}")
    return errors
