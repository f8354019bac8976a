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
