"""The disabled health monitor of ``repro.obs.health``.

The live watchers (MSE divergence/stall, quantizer saturation, stale and
death storms) arrive with the observability slice of the port; until
then a run asks for them and is refused, rather than silently running
unmonitored.
"""
from __future__ import annotations


class NullMonitor:
    """Disabled monitor: every hook is a no-op."""

    enabled = False
    alerts: tuple = ()

    def bind(self, tracer, clock) -> None:
        pass

    def observe_round(self, *a, **kw) -> None:
        pass

    def observe_quant(self, *a, **kw) -> None:
        pass

    def health_section(self) -> dict:
        return {"alerts": [], "counters": {}}


#: shared no-op instance (it holds no state)
NULL_MONITOR = NullMonitor()


def as_monitor(health) -> NullMonitor:
    """Normalize a ``health`` knob; only the disabled monitor exists yet."""
    if isinstance(health, NullMonitor) or not health:
        return NULL_MONITOR
    raise NotImplementedError(
        "health watchers are not ported yet (observability slice of the "
        "port); run with health=False")
