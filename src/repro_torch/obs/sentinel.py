"""Regression sentinel: compare a run against its ledger baseline.

Port of ``repro.obs.sentinel`` over the port's ledger; the same checks,
output and exit codes.

``python -m repro_torch.obs.sentinel`` loads the run-history ledger
(:mod:`repro_torch.obs.ledger`), takes the newest record, builds the baseline
population of earlier records with the same config key, and flags:

* **perf regressions** — warm launch-wall p50/p95 per op, virtual
  rounds/sec, and bench-row ``us_per_call``, each tested against a
  robust median/MAD band (a current value must exceed BOTH the MAD band
  and a multiplicative ratio over the baseline median, with an absolute
  floor so sub-jitter walls can't trip it);
* **correctness drift** — the record's 16-hex core signature
  (:func:`repro_torch.obs.ledger.core_signature`) differs from every baseline
  signature for the same pinned config (same workload / cipher / K /
  key_bits / seed / iters), i.e. the bit-exact report core moved;
* **convergence anomalies** — the MSE-trajectory scalars (round-0
  distance, mid-trajectory residual) leave the baseline envelope.

Exit codes: 0 = clean (or no baseline yet — a first run cannot regress),
1 = at least one finding, 2 = usage/ledger error.  ``--json`` prints the
findings machine-readably.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from . import ledger

#: default knobs — a finding requires current > band AND
#: current > ratio * median AND current - median > abs floor
DEFAULT_RATIO = 2.5
DEFAULT_MAD_K = 4.0
DEFAULT_ABS_FLOOR_MS = 0.05       # launch walls below jitter never flag
DEFAULT_ABS_FLOOR_US = 25.0       # bench rows: same idea, microseconds
DEFAULT_BASELINE = 8


def robust_band(values: list[float], k: float = DEFAULT_MAD_K,
                rel_floor: float = 0.25) -> tuple[float, float, float]:
    """``(median, lo, hi)`` — a median ± MAD band with a relative floor.

    MAD is scaled by 1.4826 (normal-consistent); tiny populations (n=1,
    MAD=0) fall back to ``rel_floor * |median|`` so a single baseline
    record still yields a usable envelope.
    """
    vals = np.asarray(values, dtype=np.float64)
    med = float(np.median(vals))
    mad = float(np.median(np.abs(vals - med)))
    half = max(k * 1.4826 * mad, rel_floor * abs(med))
    return med, med - half, med + half


def _finding(check: str, metric: str, current, baseline, message: str
             ) -> dict:
    return {"check": check, "metric": metric, "current": current,
            "baseline": baseline, "message": message}


def _flag_high(check: str, metric: str, current: float,
               base_vals: list[float], *, ratio: float, abs_floor: float,
               findings: list) -> None:
    """Flag ``current`` when it regresses HIGH out of the baseline band."""
    med, _, hi = robust_band(base_vals)
    if med <= 0:
        return
    if current > hi and current > ratio * med \
            and current - med > abs_floor:
        findings.append(_finding(
            check, metric, current, med,
            f"{metric}: {current:.4g} vs baseline median {med:.4g} "
            f"({current / med:.2f}x, band hi {hi:.4g})"))


def _flag_low(check: str, metric: str, current: float,
              base_vals: list[float], *, ratio: float,
              findings: list) -> None:
    """Flag ``current`` when it collapses LOW out of the baseline band
    (throughput-style metrics where lower is worse)."""
    med, lo, _ = robust_band(base_vals)
    if med <= 0:
        return
    if current < lo and current * ratio < med:
        findings.append(_finding(
            check, metric, current, med,
            f"{metric}: {current:.4g} vs baseline median {med:.4g} "
            f"({med / max(current, 1e-300):.2f}x slower, band lo {lo:.4g})"))


def _vals(baseline: list[dict], *keys) -> list[float]:
    out = []
    for rec in baseline:
        v = rec
        for key in keys:
            v = v.get(key) if isinstance(v, dict) else None
        if isinstance(v, (int, float)):
            out.append(float(v))
    return out


def check_record(record: dict, baseline: list[dict], *,
                 ratio: float = DEFAULT_RATIO) -> list[dict]:
    """All findings for one record against its baseline population
    (empty baseline → no findings: a first run cannot regress)."""
    findings: list[dict] = []
    if not baseline:
        return findings

    if record.get("kind") == "bench":
        cur = record.get("us_per_call")
        base = _vals(baseline, "us_per_call")
        if isinstance(cur, (int, float)) and base:
            _flag_high("perf", f"bench:{record.get('name')}", float(cur),
                       base, ratio=ratio, abs_floor=DEFAULT_ABS_FLOOR_US,
                       findings=findings)
        return findings

    # correctness drift: the pinned config's core signature moved
    sigs = {r.get("core_sig") for r in baseline if r.get("core_sig")}
    if sigs and record.get("core_sig") not in sigs:
        findings.append(_finding(
            "correctness", "core_sig", record.get("core_sig"),
            sorted(sigs),
            f"core signature {record.get('core_sig')} not in baseline "
            f"{sorted(sigs)} — report core changed for a pinned config"))

    # perf: warm launch walls per op (higher = worse) ...
    for op, dist in (record.get("warm_launch_wall_ms") or {}).items():
        for q in ("p50", "p95"):
            cur = dist.get(q)
            base = _vals(baseline, "warm_launch_wall_ms", op, q)
            if isinstance(cur, (int, float)) and base:
                _flag_high("perf", f"warm_launch_wall_ms.{op}.{q}",
                           float(cur), base, ratio=ratio,
                           abs_floor=DEFAULT_ABS_FLOOR_MS,
                           findings=findings)
    # ... and protocol rounds/sec on the virtual clock (lower = worse)
    cur = record.get("rounds_per_sec")
    base = _vals(baseline, "rounds_per_sec")
    if isinstance(cur, (int, float)) and base:
        _flag_low("perf", "rounds_per_sec", float(cur), base,
                  ratio=ratio, findings=findings)

    # convergence: the MSE-trajectory scalars leave the baseline envelope
    for metric in ("mse_round0", "mse_mid"):
        cur = record.get(metric)
        base = _vals(baseline, metric)
        if isinstance(cur, (int, float)) and base:
            _flag_high("convergence", metric, float(cur), base,
                       ratio=ratio, abs_floor=0.0, findings=findings)
    return findings


def check_latest(records: list[dict], *, last: int = DEFAULT_BASELINE,
                 ratio: float = DEFAULT_RATIO) -> tuple[dict | None, list]:
    """``(record, findings)`` for the newest ledger record."""
    if not records:
        return None, []
    current = records[-1]
    base = ledger.baseline_for(current, records[:-1], last=last)
    return current, check_record(current, base, ratio=ratio)


def render(record: dict | None, findings: list[dict],
           baseline_n: int | None = None) -> str:
    if record is None:
        return "sentinel: ledger empty — nothing to check"
    head = (f"sentinel: {record.get('kind')} record "
            f"{ledger.config_key(record)}")
    if baseline_n is not None:
        head += f" (baseline n={baseline_n})"
    lines = [head]
    if not findings:
        lines.append("  OK — within baseline envelope")
    for f in findings:
        lines.append(f"  [{f['check']}] {f['message']}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.sentinel",
        description=__doc__.splitlines()[0])
    ap.add_argument("--ledger", default=None,
                    help="ledger path (default: $REPRO_LEDGER or "
                         f"{ledger.DEFAULT_PATH})")
    ap.add_argument("--last", type=int, default=DEFAULT_BASELINE,
                    help="baseline window: trailing N same-config records")
    ap.add_argument("--ratio", type=float, default=DEFAULT_RATIO,
                    help="multiplicative regression threshold over the "
                         "baseline median")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable findings (consumed by CI)")
    args = ap.parse_args(argv)
    path = args.ledger or ledger.ledger_path()
    if path is None:
        print("sentinel: ledger disabled (REPRO_LEDGER=off)",
              file=sys.stderr)
        return 2
    records = ledger.load(path)
    current, findings = check_latest(records, last=args.last,
                                     ratio=args.ratio)
    baseline_n = (len(ledger.baseline_for(current, records[:-1],
                                          last=args.last))
                  if current else 0)
    if args.json:
        print(json.dumps({"ledger": path, "records": len(records),
                          "baseline_n": baseline_n,
                          "current": current, "findings": findings},
                         indent=1, default=str))
    else:
        print(render(current, findings, baseline_n))
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
