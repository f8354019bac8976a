"""Live protocol-health monitoring, copied from ``repro.obs.health``.

:class:`NullMonitor` is the default everywhere: ``enabled`` is False and
every hook is a no-op, so instrumented call sites guard with
``if monitor.enabled:`` before computing observables.

Watchers (each fires at most once per kind):

* ``mse_divergence`` / ``mse_stall`` — the per-round iterate step
  ``mean((x_t - x_{t-1})^2)`` rebounds far above its running minimum, or
  stops improving for a window of rounds;
* ``quant_saturation`` — the Gamma_2 encode lands values outside the code
  range ``[0, Delta]`` (``quantization.gamma2_saturation``);
* ``stale_storm``, ``death_storm``, ``queue_blowup`` — the deadline,
  probe and coalescing hooks of the event-driven runtime (their callers
  arrive with the runtime slice of the port).

A firing watcher appends to ``monitor.alerts`` and, when a tracer is
bound, emits a closed ``alert``-category span at the current virtual
time.  ``health_section()`` is the RunReport payload: the synchronous
driver embeds it at ``stats["health"]``, outside the report core.
"""
from __future__ import annotations

from . import trace as trace_mod


class Thresholds:
    """Watcher knobs with conservative defaults (see class attrs)."""

    #: iterate step must rebound above ``divergence_factor * running_min``
    divergence_factor = 100.0
    #: rounds without a new running-min step before a stall fires
    stall_window = 8
    #: fraction of clipped coordinates in one Gamma_2 encode
    saturation_frac = 0.01
    #: stale substitutions / round edges, for ``stale_rounds`` in a row
    stale_frac = 0.5
    stale_rounds = 3
    #: deaths within ``death_window`` rounds
    death_count = 2
    death_window = 4
    #: pending ops in the coalesce queue
    queue_depth = 4096

    def __init__(self, **over):
        for k, v in over.items():
            if not hasattr(type(self), k):
                raise TypeError(f"unknown health threshold {k!r}")
            setattr(self, k, v)


class HealthMonitor:
    """Collects watcher observations; fires bounded, deduplicated alerts."""

    enabled = True

    def __init__(self, thresholds: Thresholds | None = None):
        self.th = thresholds or Thresholds()
        self.alerts: list[dict] = []
        self.counters: dict[str, int] = {
            "rounds": 0, "quant_encodes": 0, "quant_clipped_values": 0,
            "stale_substitutions": 0, "deaths": 0, "max_queue_depth": 0,
        }
        self._fired: set[str] = set()
        self._tracer = trace_mod.NULL
        self._clock = lambda: 0.0
        # mse watcher state
        self._min_step: float | None = None
        self._first_step = 0.0
        self._since_min = 0
        # stale/death watcher state
        self._stale_streak = 0
        self._death_rounds: list[int] = []

    def bind(self, tracer, clock) -> None:
        """Attach the run's tracer + virtual clock (alert spans land on
        the same timeline as everything else)."""
        self._tracer = tracer
        self._clock = clock

    # -- alert plumbing --------------------------------------------------
    def _fire(self, watcher: str, message: str, **attrs) -> None:
        if watcher in self._fired:
            return
        self._fired.add(watcher)
        t = float(self._clock())
        self.alerts.append({"watcher": watcher, "t": t,
                            "message": message, **attrs})
        if self._tracer.enabled:
            self._tracer.add(f"alert:{watcher}", "alert", t=t,
                             watcher=watcher, **attrs)

    # -- watcher hooks ---------------------------------------------------
    def observe_round(self, t: int, step_mse: float) -> None:
        """Per-round iterate step ``mean((x_t - x_{t-1})^2)``."""
        self.counters["rounds"] += 1
        step = float(step_mse)
        if self._min_step is None:
            self._min_step = self._first_step = step
            return
        # the running min can legitimately touch 0.0 (a frozen round —
        # e.g. every edge recycled); the round-0 step sets the scale a
        # rebound must also clear before it counts as divergence
        if step > self.th.divergence_factor * max(self._min_step, 1e-300) \
                and step > self._first_step and step > 0:
            self._fire("mse_divergence",
                       f"round {t}: iterate step {step:.3e} rebounded "
                       f">{self.th.divergence_factor:g}x above running "
                       f"min {self._min_step:.3e}",
                       round=t, step=step, min_step=self._min_step)
        if step < self._min_step:
            self._min_step = step
            self._since_min = 0
        else:
            self._since_min += 1
            if self._since_min >= self.th.stall_window and step > 0:
                self._fire("mse_stall",
                           f"round {t}: no iterate-step improvement in "
                           f"{self._since_min} rounds (step {step:.3e})",
                           round=t, step=step, window=self._since_min)

    def observe_quant(self, t: int, clipped: int, total: int) -> None:
        """One Gamma_2 encode: ``clipped`` of ``total`` values fell
        outside the code range (see ``quantization.gamma2_saturation``)."""
        self.counters["quant_encodes"] += 1
        self.counters["quant_clipped_values"] += int(clipped)
        if total and clipped / total >= self.th.saturation_frac:
            self._fire("quant_saturation",
                       f"round {t}: quantizer clipped {clipped}/{total} "
                       f"values ({clipped / total:.1%}) — range contract "
                       f"violated, Theorem-1 dequantization is off-range",
                       round=t, clipped=int(clipped), total=int(total))

    def observe_stale(self, t: int, stale: int, round_edges: int) -> None:
        """End of a deadline round: ``stale`` of ``round_edges`` blocks
        were stale-cache substitutions."""
        self.counters["stale_substitutions"] += int(stale)
        if round_edges and stale / round_edges >= self.th.stale_frac:
            self._stale_streak += 1
            if self._stale_streak >= self.th.stale_rounds:
                self._fire("stale_storm",
                           f"round {t}: >= {self.th.stale_frac:.0%} of "
                           f"edges stale for {self._stale_streak} "
                           f"consecutive rounds (deadline too tight or "
                           f"probes running behind)",
                           round=t, stale=int(stale),
                           round_edges=int(round_edges))
        else:
            self._stale_streak = 0

    def observe_death(self, t: int, edge: int) -> None:
        """The probe machinery declared ``edge`` dead at round ``t``."""
        self.counters["deaths"] += 1
        self._death_rounds.append(t)
        recent = [r for r in self._death_rounds
                  if t - r < self.th.death_window]
        if len(recent) >= self.th.death_count:
            self._fire("death_storm",
                       f"round {t}: {len(recent)} edges declared dead "
                       f"within {self.th.death_window} rounds",
                       round=t, deaths=len(recent), edge=int(edge))

    def observe_queue_depth(self, depth: int) -> None:
        """Coalesce-queue pending-op depth after a submission."""
        if depth > self.counters["max_queue_depth"]:
            self.counters["max_queue_depth"] = int(depth)
        if depth >= self.th.queue_depth:
            self._fire("queue_blowup",
                       f"coalesce queue depth {depth} >= "
                       f"{self.th.queue_depth} pending ops",
                       depth=int(depth))

    # -- report ----------------------------------------------------------
    def health_section(self) -> dict:
        """The RunReport ``health`` payload (JSON-safe)."""
        return {"alerts": [dict(a) for a in self.alerts],
                "counters": dict(self.counters)}


class NullMonitor:
    """Disabled monitor: the overhead-free default path."""

    enabled = False
    alerts: tuple = ()

    def bind(self, tracer, clock) -> None:
        pass

    def observe_round(self, *a, **kw) -> None:
        pass

    def observe_quant(self, *a, **kw) -> None:
        pass

    def observe_stale(self, *a, **kw) -> None:
        pass

    def observe_death(self, *a, **kw) -> None:
        pass

    def observe_queue_depth(self, *a, **kw) -> None:
        pass

    def health_section(self) -> dict:
        return {"alerts": [], "counters": {}}


#: shared no-op instance — safe to alias anywhere (it holds no state);
#: named NULL_MONITOR so it can't shadow ``trace.NULL`` in ``repro.obs``
NULL_MONITOR = NullMonitor()


def as_monitor(health) -> "HealthMonitor | NullMonitor":
    """Normalize a ``health`` knob: monitor instance, truthy, or falsy."""
    if isinstance(health, (HealthMonitor, NullMonitor)):
        return health
    return HealthMonitor() if health else NULL_MONITOR
