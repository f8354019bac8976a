"""Reduce a traced window's ``torch.profiler`` record to what the metrics
and the result's breakdown read.

Only events inside the window's two marker spans count, clipped to them.
The device is busy where any device event (kernel, copy, set) runs; each
idle stretch of the device is charged to what the host was doing at its
middle: the innermost span open on the window's thread (a layer span of
:mod:`portbench.spans` or a torch operator).

Each device operation is also charged to the layer span that launched it
(:func:`launch_labels`): the innermost harness span around the torch
operator that the profiler links it to, and for an operator that the
autograd engine runs in the backward pass, the span around the forward
operator that made its node (the two share a sequence number).
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
#: a matrix product's kernel: cuBLAS's (``gemm``, ``gemv``, ``nvjet``,
#: ``xmma``, split-K reductions) and CUTLASS's
GEMM = re.compile(r"gemm|gemv|nvjet|xmma|cutlass|splitK", re.IGNORECASE)
#: the scope the autograd engine opens around one node's backward
BACKWARD = "autograd::engine::evaluate_function: "


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
    #: device seconds of every operation in the window, summed
    device_s: float = 0.0
    #: device seconds by the harness span that launched them ("" where
    #: no span did)
    span_device_s: dict = dataclasses.field(default_factory=dict)
    #: device seconds of matrix-product kernels (:data:`GEMM`), by the
    #: harness span that launched them
    gemm_device_s: dict = dataclasses.field(default_factory=dict)


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


def launch_labels(ops, labels) -> dict:
    """``{correlation id: harness span}`` of every torch operator in
    ``ops`` (``(start, end, thread, name, sequence_nr, correlation_id)``
    of the profiler's host operators): the innermost span of ``labels``
    open around it on its thread.  Inside the autograd engine's scope for
    one node, the node's own span stands in: the one around the forward
    operators that share its sequence number (the last of them made the
    node).  An operator under no span gets ``""``."""
    threads = collections.defaultdict(list)
    for op in ops:
        threads[op[2]].append(op)
    for evs in threads.values():
        evs.sort(key=lambda e: (e[0], -e[1]))

    def sweep(forward_of):
        out = {}
        for evs in threads.values():
            stack = []                   # (end, span, under a backward)
            for s, t, _, name, seq, corr in evs:
                while stack and stack[-1][0] <= s:
                    stack.pop()
                span, back = stack[-1][1:] if stack else ("", False)
                if name in labels:
                    span = name
                elif name.startswith(BACKWARD):
                    back = True
                    if forward_of is not None:
                        span = forward_of.get(seq, span)
                elif forward_of is None and not back and seq >= 0:
                    out[seq] = span
                stack.append((t, span, back))
                if forward_of is not None:
                    out[corr] = span
        return out
    return sweep(sweep(None))


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
    device, host, ops = [], [], []
    for e in events:
        start = e.start_ns()
        end = start + e.duration_ns()
        name = e.name()
        on_device = e.device_type() == device_type
        linked = e.linked_correlation_id()
        tid = e.start_thread_id()
        if not on_device and not linked:
            ops.append((start, end, tid, name, e.sequence_nr(),
                        e.correlation_id()))
        s, t = max(start, w0), min(end, w1)
        if t <= s:
            continue
        if on_device:
            if name not in skip and not _annotation(e):
                device.append((s, t, name, linked))
        elif tid == thread and name not in (OPEN, CLOSE):
            host.append((s, t, name))
    busy = _union((s, t) for s, t, _, _ in device)
    # only scopes, forward operators and launching operators bear on a
    # device operation's span
    scopes, wanted = set(labels), {corr for *_, corr in device}
    ops = [op for op in ops if op[4] >= 0 or op[5] in wanted
           or op[3] in scopes or op[3].startswith(BACKWARD)]
    launched = launch_labels(ops, scopes)
    by_op, by_fn = collections.Counter(), collections.Counter()
    by_span, by_gemm = collections.Counter(), collections.Counter()
    for s, t, name, corr in device:
        by_op[name.split("(")[0]] += (t - s) / 1e9
        fn = kernel_function(name)
        if fn:
            by_fn[fn] += (t - s) / 1e9
        span = launched.get(corr, "")
        by_span[span] += (t - s) / 1e9
        if GEMM.search(name):
            by_gemm[span] += (t - s) / 1e9
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
        idle_gaps=[[n, s] for n, s in idle.most_common(TOP)],
        device_s=sum(by_span.values()), span_device_s=dict(by_span),
        gemm_device_s=dict(by_gemm))
