"""Chrome-trace / Perfetto JSON export for the span tracer, copied from
``repro.obs.chrome_trace``.

``edge_sim --trace out.json`` (and anything else holding a
:class:`~repro_torch.obs.trace.Tracer`) writes the JSON object format that
``chrome://tracing`` and https://ui.perfetto.dev load directly:

* every span becomes a complete event (``"ph": "X"``) with microsecond
  timestamps on the **virtual clock** — one process, one named thread
  lane per span category, so phases, kernel launches, messages, dispatch
  decisions, re-shares and aggregation rounds stack into parallel tracks;
* span attrs (op, shape, bytes, edge, coalesce width, backend, measured
  ``wall_ms``...) ride in ``args`` and show in the selection panel;
* the run's :mod:`RunReport <repro_torch.obs.metrics>` is embedded under the
  top-level ``"runReport"`` key (legal in the object format — viewers
  ignore unknown keys), so the report travels with its trace.

``TRACE_SCHEMA_VERSION`` guards the envelope; ``validate`` checks an
exported document.
"""
from __future__ import annotations

import json

from . import metrics as metrics_mod
from .trace import CATEGORIES, Span, Tracer, spans_from_dicts

TRACE_SCHEMA_VERSION = 1

_PID = 1
#: lane (tid) per category, in display order
_TIDS = {cat: i for i, cat in enumerate(CATEGORIES)}

# complete events with dur=0 are invisible in chrome://tracing; give
# instantaneous spans a 1-tick floor so every event stays clickable
_MIN_DUR_US = 1e-3


def _s_to_us(t: float) -> float:
    return t * 1e6


def to_chrome(spans: list[Span], run_report: dict | None = None) -> dict:
    """The chrome://tracing JSON object for a span list."""
    events: list[dict] = []
    for cat, tid in _TIDS.items():
        events.append({"ph": "M", "pid": _PID, "tid": tid,
                       "name": "thread_name", "args": {"name": cat}})
        events.append({"ph": "M", "pid": _PID, "tid": tid,
                       "name": "thread_sort_index", "args": {"sort_index": tid}})
    events.append({"ph": "M", "pid": _PID, "name": "process_name",
                   "args": {"name": "repro_torch virtual clock"}})
    for s in spans:
        args = dict(s.attrs)
        if s.wall_ms is not None:
            args["wall_ms"] = s.wall_ms
        events.append({
            "name": s.name, "cat": s.cat, "ph": "X", "pid": _PID,
            "tid": _TIDS.get(s.cat, len(_TIDS)),
            "ts": _s_to_us(s.t),
            "dur": max(_s_to_us(s.dur), _MIN_DUR_US),
            "args": args,
        })
    out = {
        "schema_version": TRACE_SCHEMA_VERSION,
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"clock": "virtual seconds (ts in us)",
                      "categories": list(CATEGORIES)},
        "spans": [s.as_dict() for s in spans],   # lossless round-trip
    }
    if run_report is not None:
        out["runReport"] = run_report
    return out


def write(path: str, tracer: Tracer, run_report: dict | None = None) -> dict:
    """Export ``tracer`` (plus an optional RunReport) to ``path``."""
    doc = to_chrome(list(tracer.spans), run_report=run_report)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
    return doc


def load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_spans(doc: dict) -> list[Span]:
    """Rehydrate the span list from an exported trace document."""
    return spans_from_dicts(doc.get("spans", []))


def validate(doc: dict, where: str = "trace") -> list[str]:
    """Schema errors (empty list = valid) for an exported trace file."""
    errors = []
    if not isinstance(doc, dict):
        return [f"{where}: not a JSON object"]
    if doc.get("schema_version") != TRACE_SCHEMA_VERSION:
        errors.append(f"{where}: schema_version "
                      f"{doc.get('schema_version')!r} != "
                      f"{TRACE_SCHEMA_VERSION}")
    events = doc.get("traceEvents")
    if not isinstance(events, list) or not events:
        return errors + [f"{where}: traceEvents missing/empty"]
    for i, ev in enumerate(events):
        if not isinstance(ev, dict) or "ph" not in ev:
            errors.append(f"{where}: traceEvents[{i}] malformed")
            continue
        if ev["ph"] == "X":
            for key in ("name", "ts", "dur", "pid", "tid"):
                if key not in ev:
                    errors.append(f"{where}: traceEvents[{i}] missing {key}")
            if ev.get("cat") not in CATEGORIES:
                errors.append(f"{where}: traceEvents[{i}] unknown cat "
                              f"{ev.get('cat')!r}")
    for i, s in enumerate(doc.get("spans", [])):
        if not isinstance(s, dict) or s.get("cat") not in CATEGORIES:
            errors.append(f"{where}: spans[{i}] malformed")
    if "runReport" in doc:
        errors.extend(metrics_mod.validate_report_core(
            doc["runReport"], where=f"{where}.runReport"))
    return errors
