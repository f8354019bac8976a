"""What several metric readers share."""
from __future__ import annotations

import numpy as np

from . import counts


def percentile(values, q: float) -> float | None:
    """The q-th percentile (linear between order statistics)."""
    return float(np.percentile(values, q)) if len(values) else None


def launches_per(run, count: int) -> float | None:
    total = sum(run.launches.values())
    return total / count if total and count else None


def roofline(run, functions=counts.FUNCTIONS) -> float | None:
    """Least seconds of the window's launches of ``functions`` over their
    kernels' device seconds in the trace, in percent."""
    if run.trace is None:
        return None
    device = sum(run.trace.function_s.get(fn, 0.0) for fn in functions)
    least = sum(counts.least_seconds_of(
        run.shape_launches, functions=functions, **run.inputs).values())
    if device <= 0 or least <= 0:
        return None
    return 100.0 * least / device


def idle_share(run) -> float | None:
    """Share of the traced window with nothing running on the device."""
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def span_share(run, span: str) -> float | None:
    """Share of the traced window's device seconds launched under the
    harness span ``span``, in percent; ``None`` where it launched
    nothing."""
    if run.trace is None or run.trace.device_s <= 0:
        return None
    seconds = run.trace.span_device_s.get(span, 0.0)
    return 100.0 * seconds / run.trace.device_s if seconds > 0 else None


def gemm_share(run, exclude=()) -> float | None:
    """Share of the traced window's device seconds in matrix-product
    kernels launched outside the spans ``exclude``, in percent."""
    if run.trace is None or run.trace.device_s <= 0:
        return None
    seconds = sum(s for span, s in run.trace.gemm_device_s.items()
                  if span not in exclude)
    return 100.0 * seconds / run.trace.device_s if seconds > 0 else None
