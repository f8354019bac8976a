"""Append-only JSONL run-history ledger, ported from ``repro.obs.ledger``.

Every completed protocol run (``core.protocol.run_protocol`` and
``runtime.runner.run_on_runtime``) appends one compact JSON line, so
longitudinal claims have a baseline population to regress against
instead of a single overwritten snapshot.

The ledger lives at ``~/.cache/repro_torch/ledger.jsonl`` by default; the
``REPRO_LEDGER`` environment variable overrides the path, and setting it
to ``off`` / ``0`` / empty disables recording entirely.  Appends are
best-effort: a read-only filesystem or a malformed environment must
never fail a run (``record_run`` swallows OSError).

Record kinds (``LEDGER_SCHEMA_VERSION`` guards the envelope, the
reference's):

* ``kind="run"`` — RunReport core distilled per run: the identifying
  config (workload / cipher / K / key_bits / seed / iters / driver /
  mode), a stable **core signature** (sha256 over the canonical JSON of
  :func:`repro_torch.obs.metrics.report_core`), convergence scalars from
  the MSE trajectory, timing summaries (warm/cold launch walls per op,
  virtual rounds/sec) and the environment fingerprint below.
* ``kind="bench"`` — one benchmark row (``bench`` key, row ``name``,
  ``us_per_call``, ``derived``).

The environment fingerprint (``env_fingerprint``) records what the
numbers were measured ON: the run's device kind
(``runtime.dispatch.device_kind``: ``torch-cpu`` or
``torch-cuda-<card name>``), the active ``REPRO_REDUCE_IMPL`` /
``REPRO_MODEXP_METHOD`` ladder knobs, torch/numpy versions, the git
commit, and the Python version.

Query helpers (:func:`load`, :func:`query`, :func:`baseline_for`) build
median/MAD baseline populations.
"""
from __future__ import annotations

import functools
import hashlib
import itertools
import json
import os
import subprocess
import sys
import time

from . import metrics as metrics_mod

#: ledger record envelope version ("v" in every record), the reference's
LEDGER_SCHEMA_VERSION = 1

DEFAULT_PATH = "~/.cache/repro_torch/ledger.jsonl"

#: the config axes that make two run records comparable: a baseline
#: population is the trailing records sharing all of them
CONFIG_KEYS = ("kind", "driver", "workload", "cipher", "K", "key_bits",
               "seed", "iters", "mode")

#: process-local sequence counter so same-timestamp appends stay distinct
_seq = itertools.count()


# ---------------------------------------------------------------------------
# path / enablement
# ---------------------------------------------------------------------------

def ledger_path() -> str | None:
    """Resolved ledger path, or ``None`` when recording is disabled."""
    raw = os.environ.get("REPRO_LEDGER", DEFAULT_PATH)
    if raw.strip().lower() in ("", "0", "off", "none", "disabled"):
        return None
    return os.path.expanduser(raw)


# ---------------------------------------------------------------------------
# environment fingerprint + core signature
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _git_sha() -> str | None:
    try:
        out = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                             capture_output=True, text=True, timeout=5)
        return out.stdout.strip() or None if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError):
        return None


@functools.lru_cache(maxsize=None)
def env_fingerprint(device: str | None = None) -> dict:
    """Where the numbers came from: device kind, ladder knobs, versions.
    ``device`` is the run's (``"cpu"``, ``"cuda"``, ``"cuda:0"``...);
    ``None`` records no device."""
    import numpy as np
    import torch
    kind = None
    if device is not None:
        from ..runtime.dispatch import device_kind
        kind = device_kind(device)
    return {
        "device": kind,
        "reduce_impl": os.environ.get("REPRO_REDUCE_IMPL", "montgomery"),
        "modexp_method": os.environ.get("REPRO_MODEXP_METHOD"),
        "torch": torch.__version__,
        "numpy": np.__version__,
        "python": ".".join(map(str, sys.version_info[:3])),
        "git": _git_sha(),
    }


def core_signature(report: dict) -> str:
    """Stable 16-hex-digit hash of a RunReport's core sections.

    Two reports that are "equal modulo timing" hash identically, so a
    signature change for a pinned config IS a correctness drift (the
    sentinel's cheapest and sharpest check).
    """
    core = metrics_mod.report_core(report)
    blob = json.dumps(core, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


# ---------------------------------------------------------------------------
# record builders
# ---------------------------------------------------------------------------

def _mse_scalars(traj: list) -> dict:
    """Convergence scalars from the MSE-to-final trajectory.  The final
    entry is 0 by construction, so the envelope the sentinel compares is
    the entry curve: round-0 distance and the mid-trajectory residual."""
    out = {"rounds": len(traj)}
    if traj:
        out["mse_round0"] = float(traj[0])
        out["mse_mid"] = float(traj[len(traj) // 2])
    return out


def _warm_walls(report: dict) -> dict:
    """Per-op warm launch-wall p50/p95 (ms) from the runtime telemetry."""
    walls = report.get("runtime", {}).get("coalesce", {}) \
        .get("launch_wall_ms", {})
    out = {}
    for op, dist in walls.items():
        warm = dist.get("warm") or {}
        if warm.get("n"):
            out[op] = {"p50": warm["p50"], "p95": warm["p95"],
                       "n": warm["n"]}
    return out


def record_from_report(report: dict, *, cfg=None, mode: str | None = None,
                       extra: dict | None = None,
                       device: str | None = None) -> dict:
    """Build (without appending) the ``kind="run"`` record for a report."""
    rec = {
        "v": LEDGER_SCHEMA_VERSION,
        "kind": "run",
        "ts": time.time(),
        "seq": next(_seq),
        "driver": report.get("driver"),
        "workload": report.get("workload"),
        "cipher": report.get("cipher"),
        "key_bits": report.get("key_bits"),
        "schema_version": report.get("schema_version"),
        "core_sig": core_signature(report),
        "reshare_events": report.get("reshare_events", 0),
        "churn": dict(report.get("churn", {})),
        "env": env_fingerprint(None if device is None else str(device)),
    }
    if cfg is not None:
        rec["K"] = cfg.K
        rec["seed"] = cfg.seed
        rec["iters"] = cfg.iters
    rec["mode"] = mode
    rec.update(_mse_scalars(report.get("mse_trajectory") or []))
    rt = report.get("runtime")
    if rt:
        rec["virtual_time"] = rt.get("virtual_time")
        rounds = rec.get("rounds") or 0
        if rounds and rt.get("virtual_time"):
            rec["rounds_per_sec"] = rounds / rt["virtual_time"]
        walls = _warm_walls(report)
        if walls:
            rec["warm_launch_wall_ms"] = walls
        alerts = rt.get("health", {}).get("alerts")
        if alerts:
            rec["alerts"] = len(alerts)
    if extra:
        rec.update(extra)
    return rec


def record_bench_row(bench: str, name: str, us_per_call: float,
                     derived: str = "", device: str | None = None) -> dict:
    """Build (without appending) the ``kind="bench"`` record for one
    benchmark row."""
    return {
        "v": LEDGER_SCHEMA_VERSION,
        "kind": "bench",
        "ts": time.time(),
        "seq": next(_seq),
        "bench": bench,
        "name": name,
        "us_per_call": float(us_per_call),
        "derived": derived,
        "env": env_fingerprint(None if device is None else str(device)),
    }


# ---------------------------------------------------------------------------
# append / load / query
# ---------------------------------------------------------------------------

def append(record: dict, path: str | None = None) -> bool:
    """Append one record (one JSON line).  Returns False when the ledger
    is disabled or the write failed — recording never raises."""
    path = path or ledger_path()
    if path is None:
        return False
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "a") as f:
            f.write(json.dumps(record, sort_keys=True,
                               separators=(",", ":")) + "\n")
        return True
    except OSError:
        return False


def record_run(report: dict, *, cfg=None, mode: str | None = None,
               extra: dict | None = None, path: str | None = None,
               device: str | None = None) -> bool:
    """Build and append the run record for a completed protocol run on
    ``device``.

    Called by both drivers at completion; a disabled ledger costs one
    env lookup and nothing else.
    """
    if (path or ledger_path()) is None:
        return False
    try:
        rec = record_from_report(report, cfg=cfg, mode=mode, extra=extra,
                                 device=device)
    except Exception:           # a report quirk must never fail the run
        return False
    return append(rec, path=path)


def load(path: str | None = None) -> list[dict]:
    """All parseable records, in append order (corrupt lines skipped)."""
    path = path or ledger_path()
    if path is None or not os.path.exists(path):
        return []
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(rec, dict):
                records.append(rec)
    return records


def config_key(record: dict) -> tuple:
    """The identity under which records form one baseline population.

    Bench rows are identified by their (bench, name) pair; run records
    by the :data:`CONFIG_KEYS` config axes.
    """
    if record.get("kind") == "bench":
        return ("bench", record.get("bench"), record.get("name"))
    return tuple(record.get(k) for k in CONFIG_KEYS)


def query(records: list[dict] | None = None, *, path: str | None = None,
          kind: str | None = None, workload: str | None = None,
          cipher: str | None = None, K: int | None = None,
          key_bits: int | None = None, last: int | None = None
          ) -> list[dict]:
    """Filter records by the common config axes; ``last`` keeps the
    trailing N matches (the usual baseline window)."""
    recs = load(path) if records is None else records
    want = {"kind": kind, "workload": workload, "cipher": cipher,
            "K": K, "key_bits": key_bits}
    out = [r for r in recs
           if all(v is None or r.get(k) == v for k, v in want.items())]
    return out[-last:] if last else out


def baseline_for(record: dict, records: list[dict],
                 last: int = 8) -> list[dict]:
    """The trailing ``last`` records sharing ``record``'s config key,
    excluding the record itself (matched by (ts, seq) identity)."""
    key = config_key(record)
    ident = (record.get("ts"), record.get("seq"))
    pop = [r for r in records
           if config_key(r) == key and (r.get("ts"), r.get("seq")) != ident]
    return pop[-last:]
