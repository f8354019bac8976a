"""Human-readable rendering and A/B diffing of RunReports and traces.

Port of ``repro.obs.report``; the same text, JSON and exit codes.

Usage::

  python -m repro_torch.obs.report run.json            # summarize one run
  python -m repro_torch.obs.report a.json b.json       # diff two runs (A/B)

``run.json`` is either an exported chrome-trace file (``edge_sim
--trace`` or ``serve_sim --trace``: spans + embedded RunReport) or a bare
RunReport JSON.  The
single-file view prints the phase table (crypto ops + virtual duration),
the coalescing/dispatch breakdown, latency distributions, health alerts
(``edge_sim --health``), and the top spans by measured kernel wall time;
the two-file view diffs the core sections (ops, bytes, MSE) and compares
the timing telemetry.  Diff mode exits 1 when the core sections differ
(CI-gateable); ``--json`` switches either mode to machine-readable
output.
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict

from . import chrome_trace, metrics


def _fmt_s(v) -> str:
    if v is None:
        return "-"
    if v >= 1.0:
        return f"{v:.3f}s"
    if v >= 1e-3:
        return f"{v * 1e3:.2f}ms"
    return f"{v * 1e6:.1f}us"


def _table(rows: list[list[str]], header: list[str]) -> str:
    widths = [max(len(str(r[i])) for r in [header] + rows)
              for i in range(len(header))]
    def line(r):
        return "  ".join(str(c).ljust(w) for c, w in zip(r, widths)).rstrip()
    out = [line(header), line(["-" * w for w in widths])]
    out.extend(line(r) for r in rows)
    return "\n".join(out)


def load_any(path: str) -> tuple[dict | None, list]:
    """``(run_report, spans)`` from a trace file or bare report JSON."""
    with open(path) as f:
        doc = json.load(f)
    if "traceEvents" in doc:
        return doc.get("runReport"), chrome_trace.load_spans(doc)
    return doc, []


# ---------------------------------------------------------------------------
# single-run summary
# ---------------------------------------------------------------------------

def _phase_table(report: dict | None, spans: list) -> str:
    # phase spans are named "phase:<name>"; "round:<t>" spans are per-round
    phase_dur = {s.name.split(":", 1)[1]: s.dur for s in spans
                 if s.cat == "phase" and s.name.startswith("phase:")}
    ops = (report or {}).get("ops", {})
    phases = list(ops) or list(phase_dur)
    rows = []
    for ph in phases:
        op_str = " ".join(f"{op}={n}" for op, n in ops.get(ph, {}).items())
        rows.append([ph, _fmt_s(phase_dur.get(ph)), op_str or "-"])
    return _table(rows, ["phase", "virtual", "crypto ops"])


def _coalesce_section(report: dict | None, spans: list) -> list[str]:
    lines = []
    rt = (report or {}).get("runtime", {})
    co = rt.get("coalesce")
    if co:
        lines.append(f"coalesce: launches={co.get('launches')} "
                     f"coalesced_ops={co.get('coalesced_ops')} "
                     f"held_flushes={co.get('held_flushes')} "
                     f"hold_ticks={rt.get('coalesce_hold_ticks')}")
        hist = co.get("ops_per_launch", {})
        if hist.get("n"):
            lines.append(f"  ops/launch: mean={hist['mean']:.2f} "
                         f"p50={hist['p50']:.0f} p95={hist['p95']:.0f} "
                         f"max={hist['max']:.0f} (n={hist['n']})")
        for op, dist in sorted(co.get("launch_wall_ms", {}).items()):
            parts = []
            for kind in ("cold", "warm"):
                d = dist.get(kind, {})
                if d.get("n"):
                    parts.append(f"{kind} p50={d['p50']:.3f}ms "
                                 f"p95={d['p95']:.3f}ms n={d['n']}")
            if parts:
                lines.append(f"  {op}: " + "; ".join(parts))
    launch_spans = [s for s in spans if s.cat == "launch"]
    if launch_spans and not co:
        widths = [s.attrs.get("width", 1) for s in launch_spans]
        lines.append(f"coalesce (from spans): launches={len(launch_spans)} "
                     f"mean ops/launch="
                     f"{sum(widths) / max(len(widths), 1):.2f}")
    return lines


def _dispatch_section(report: dict | None, spans: list) -> list[str]:
    rt = (report or {}).get("runtime", {})
    choices = dict(rt.get("dispatch", {}))
    if not choices:
        counts: dict[str, int] = defaultdict(int)
        for s in spans:
            if s.cat == "dispatch":
                counts[s.name] += 1
        choices = dict(counts)
    if not choices:
        return []
    body = " ".join(f"{k}={v}" for k, v in sorted(choices.items()))
    return [f"dispatch: {body}"]


def _top_spans(spans: list, n: int = 10) -> str:
    timed = [s for s in spans if s.wall_ms is not None]
    key = "wall_ms"
    if not timed:
        timed, key = [s for s in spans if s.dur > 0], "dur"
    timed.sort(key=lambda s: (s.wall_ms if key == "wall_ms" else s.dur),
               reverse=True)
    rows = []
    for s in timed[:n]:
        cost = f"{s.wall_ms:.3f}ms wall" if key == "wall_ms" \
            else _fmt_s(s.dur) + " virtual"
        attrs = " ".join(f"{k}={v}" for k, v in sorted(s.attrs.items()))
        rows.append([s.name, s.cat, cost, attrs])
    if not rows:
        return ""
    return _table(rows, ["span", "cat", "cost", "attrs"])


def health_of(report: dict | None) -> dict | None:
    """The ``health`` section wherever the driver put it: top-level for
    the synchronous driver, under ``runtime`` for the event-driven one
    (see ``repro_torch.obs.health``)."""
    if not report:
        return None
    return report.get("health") or report.get("runtime", {}).get("health")


def _health_section(report: dict | None) -> list[str]:
    h = health_of(report)
    if not h:
        return []
    alerts = h.get("alerts", [])
    lines = [f"health: alerts={len(alerts)} " +
             " ".join(f"{k}={v}" for k, v in
                      sorted(h.get("counters", {}).items()))]
    for a in alerts:
        lines.append(f"  ALERT {a.get('watcher')} @t={a.get('t')}: "
                     f"{a.get('message')}")
    return lines


def summarize(report: dict | None, spans: list) -> str:
    out = []
    if report:
        mse = report.get("mse_trajectory") or []
        out.append(f"run: workload={report.get('workload')} "
                   f"cipher={report.get('cipher')} "
                   f"key_bits={report.get('key_bits')} "
                   f"driver={report.get('driver')} "
                   f"schema=v{report.get('schema_version')}")
        traffic = report.get("traffic_bytes", {})
        out.append(f"traffic: " + " ".join(f"{k}={v}"
                                           for k, v in traffic.items()))
        if mse:
            out.append(f"mse-to-final: round0={mse[0]:.3e} "
                       f"last={mse[-1]:.3e} rounds={len(mse)}")
        if report.get("reshare_events"):
            out.append(f"reshare_events: {report['reshare_events']}")
        rt = report.get("runtime", {})
        if rt:
            out.append(f"runtime: topology={rt.get('topology')} "
                       f"mode={rt.get('mode')} "
                       f"virtual={_fmt_s(rt.get('virtual_time'))} "
                       f"events={rt.get('events')} "
                       f"max_queue_depth={rt.get('max_queue_depth')}")
    out.append("")
    out.append(_phase_table(report, spans))
    co = _coalesce_section(report, spans)
    if co:
        out.append("")
        out.extend(co)
    disp = _dispatch_section(report, spans)
    if disp:
        out.extend(disp)
    health = _health_section(report)
    if health:
        out.append("")
        out.extend(health)
    top = _top_spans(spans)
    if top:
        out.append("")
        out.append("top spans:")
        out.append(top)
    return "\n".join(out)


# ---------------------------------------------------------------------------
# A/B diff
# ---------------------------------------------------------------------------

def diff(a: dict | None, b: dict | None, name_a: str, name_b: str) -> str:
    if a is None or b is None:
        return "diff needs a RunReport in both files (re-export with --trace)"
    out = [f"A = {name_a}", f"B = {name_b}", ""]
    core = metrics.diff_reports(a, b, "A", "B")
    if core:
        out.append("core sections differ:")
        out.extend("  " + line for line in core)
    else:
        out.append("core sections identical (ops / bytes / MSE) — "
                   "equal modulo timing")
    rows = []
    for label, getter in (
            ("virtual_time", lambda r: r.get("runtime", {})
             .get("virtual_time")),
            ("launches", lambda r: r.get("runtime", {})
             .get("coalesce", {}).get("launches")),
            ("coalesced_ops", lambda r: r.get("runtime", {})
             .get("coalesce", {}).get("coalesced_ops")),
            ("events", lambda r: r.get("runtime", {}).get("events")),
            ("reshare_events", lambda r: r.get("reshare_events"))):
        va, vb = getter(a), getter(b)
        if va is None and vb is None:
            continue
        rows.append([label, str(va), str(vb)])
    if rows:
        out.append("")
        out.append(_table(rows, ["timing/telemetry", "A", "B"]))
    return "\n".join(out)


def summary_json(report: dict | None, spans: list) -> dict:
    """Machine-readable single-run summary (``--json``)."""
    rt = dict((report or {}).get("runtime", {}))
    rt.pop("trace", None)       # spans are huge; count them instead
    rt.pop("profile", None)
    return {"kind": "summary",
            "core": metrics.report_core(report) if report else None,
            "runtime": rt or None,
            "health": health_of(report),
            "spans": len(spans)}


def diff_json(a: dict | None, b: dict | None,
              name_a: str, name_b: str) -> dict:
    """Machine-readable A/B diff (``--json``)."""
    core = [] if a is None or b is None \
        else metrics.diff_reports(a, b, "A", "B")
    return {"kind": "diff", "a": name_a, "b": name_b,
            "loaded": a is not None and b is not None,
            "core_identical": not core and a is not None and b is not None,
            "core_diff": core}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description=__doc__.splitlines()[0])
    ap.add_argument("files", nargs="+",
                    help="one file to summarize, two to diff (trace JSON "
                         "from edge_sim --trace, or bare RunReport JSON)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output for either mode")
    args = ap.parse_args(argv)
    if len(args.files) > 2:
        ap.error("pass one file (summary) or two (diff)")
    loaded = [load_any(p) for p in args.files]
    if len(loaded) == 1:
        report, spans = loaded[0]
        if args.json:
            print(json.dumps(summary_json(report, spans), indent=2))
        else:
            print(summarize(report, spans))
        return 0
    (ra, _), (rb, _) = loaded
    doc = diff_json(ra, rb, args.files[0], args.files[1])
    if args.json:
        print(json.dumps(doc, indent=2))
    else:
        print(diff(ra, rb, args.files[0], args.files[1]))
    # CI gate: identical cores -> 0, anything else -> 1
    return 0 if doc["core_identical"] else 1


if __name__ == "__main__":
    sys.exit(main())
