"""Reduce a traced window's ``torch.profiler`` record to what the metrics
and the result's breakdown read.

Only events inside the window's two marker spans count, clipped to them.
The device is busy where any device event (kernel, copy, set) runs; each
idle stretch of the device is charged to what the host was doing at its
middle: the innermost span open on the window's thread (a layer span of
:mod:`portbench.spans` or a torch operator).
"""
from __future__ import annotations

import collections
import dataclasses
import re

OPEN, CLOSE = "portbench.window.open", "portbench.window.close"
#: a hand-written kernel's symbol (``csrc/*.cu``), demangled or not, and
#: the function it computes
KERNEL = re.compile(r"(?<![A-Za-z_])(mulmod_rows|modexp_rows|modexp_fixed|"
                    r"prod_rows|mulmod|modexp)_kernel(?![a-z_])")
NO_SPAN = "host: no span open"
TOP = 10


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    #: device seconds of the hand-written kernels, by function
    function_s: dict
    #: the device operations that took most time: [name, seconds]
    device_ops: list
    #: the device's idle seconds, by what the host was doing: [name, s]
    idle_gaps: list


def kernel_function(name: str) -> str | None:
    match = KERNEL.search(name)
    return match.group(1) if match else None


def _annotation(event) -> bool:
    """A user span's device-side copy (no device work)."""
    flag = getattr(event, "is_user_annotation", None)
    return bool(flag()) if flag is not None else False


def _union(intervals):
    merged = []
    for s, t in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    return merged


def summarize(events, device_type, labels=()) -> TraceSummary:
    """``events``: the profiler's raw events
    (``prof.profiler.kineto_results.events()``); ``device_type``: the
    ``DeviceType`` of the device's events; ``labels``: the names of the
    harness's own spans, whose device-side copies (the profiler's user
    annotations) are no device work."""
    marks = {e.name(): e for e in events if e.name() in (OPEN, CLOSE)}
    if OPEN not in marks or CLOSE not in marks:
        raise RuntimeError("the trace holds no window markers")
    w0, w1 = marks[OPEN].start_ns(), marks[CLOSE].start_ns()
    thread = marks[OPEN].start_thread_id()
    skip = {OPEN, CLOSE, *labels}
    device, host = [], []
    for e in events:
        start = e.start_ns()
        s, t = max(start, w0), min(start + e.duration_ns(), w1)
        if t <= s:
            continue
        name = e.name()
        if e.device_type() == device_type:
            if name not in skip and not _annotation(e):
                device.append((s, t, name))
        elif e.start_thread_id() == thread and name not in (OPEN, CLOSE):
            host.append((s, t, name))
    busy = _union((s, t) for s, t, _ in device)
    by_op, by_fn = collections.Counter(), collections.Counter()
    for s, t, name in device:
        by_op[name.split("(")[0]] += (t - s) / 1e9
        fn = kernel_function(name)
        if fn:
            by_fn[fn] += (t - s) / 1e9
    gaps, prev = [], w0
    for s, t in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    if w1 > prev:
        gaps.append((prev, w1))
    idle = collections.Counter()
    host.sort(key=lambda e: (e[0], -e[1]))
    stack, i = [], 0
    for a, b in gaps:
        mid = (a + b) / 2
        while i < len(host) and host[i][0] <= mid:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        idle[stack[-1][2] if stack else NO_SPAN] += (b - a) / 1e9
    return TraceSummary(
        window_s=(w1 - w0) / 1e9,
        busy_s=sum(t - s for s, t in busy) / 1e9,
        function_s=dict(by_fn),
        device_ops=[[n, s] for n, s in by_op.most_common(TOP)],
        idle_gaps=[[n, s] for n, s in idle.most_common(TOP)])
