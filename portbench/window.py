"""The measured window: its wall clock, the kernel launches made inside
it, and in a traced run the profiler's record of it.

A driver arms the window around its timed call and opens and closes it at
the window's bounds.  In a traced run the profiler records from arming to
disarming; two marker spans at the bounds let the trace reader keep only
what falls inside, and the layer spans of :mod:`portbench.spans` name
what the host was doing.
"""
from __future__ import annotations

import collections
import contextlib
import time

from . import spans
from .trace import CLOSE, OPEN


class Window:
    def __init__(self, device: str, trace: bool):
        import torch
        from repro_torch.kernels import build
        self.torch, self.build = torch, build
        self.cuda = torch.device(device).type == "cuda"
        self.trace = trace
        self.prof = None
        self.t_open = self.t_close = None
        self.launches: dict = {}
        self.shape_launches: dict = {}
        self.laps: list = []

    def _sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()

    def _mark(self, name: str) -> None:
        if self.trace:
            with self.torch.profiler.record_function(name):
                pass

    @contextlib.contextmanager
    def armed(self):
        """Profile the block in a traced run (one profiler a process)."""
        if not self.trace:
            yield
            return
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.cuda:
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        with spans.installed():
            self.prof.start()
            try:
                yield
            finally:
                self._sync()
                self.prof.stop()

    @contextlib.contextmanager
    def phases(self, rounds: int | None = None):
        """Time every round on the host clock at the program's phase
        clock laps (each lap synchronizes the device first), into
        ``laps``: a round from the end of the one before, or of its
        clock's share phase.  With ``rounds``, open the window where the
        first share phase ends and close it where round ``rounds`` ends."""
        from repro_torch.core import protocol
        real = protocol._PhaseClock.lap
        last = {}

        def lap(clock, phase):
            real(clock, phase)
            now = time.perf_counter()
            if phase == protocol.PHASE_ITERATE:
                self.laps.append(now - last[id(clock)])
            last[id(clock)] = now
            if rounds is None:
                return
            if phase == protocol.PHASE_SHARE and self.t_open is None:
                self.open()
            elif phase == protocol.PHASE_ITERATE \
                    and len(self.laps) == rounds:
                self.close()

        protocol._PhaseClock.lap = lap
        try:
            yield
        finally:
            protocol._PhaseClock.lap = real

    def open(self) -> None:
        self._sync()
        self._launches0 = dict(self.build.LAUNCHES)
        self._shapes0 = collections.Counter(self.build.SHAPE_LAUNCHES)
        self._mark(OPEN)
        self.t_open = time.perf_counter()

    def close(self) -> None:
        self._sync()
        self.t_close = time.perf_counter()
        self._mark(CLOSE)
        self.launches = {
            body: n - self._launches0.get(body, 0)
            for body, n in self.build.LAUNCHES.items()
            if n > self._launches0.get(body, 0)}
        self.shape_launches = {
            shape: n - self._shapes0[shape]
            for shape, n in self.build.SHAPE_LAUNCHES.items()
            if n > self._shapes0[shape]}

    @property
    def seconds(self) -> float:
        if self.t_open is None or self.t_close is None:
            raise RuntimeError("the window was not opened and closed")
        return self.t_close - self.t_open
