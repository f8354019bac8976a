"""One job on the event-driven runtime (``runtime.runner.run_on_runtime``).

As the ``protocol`` driver, with the traffic's ``mode`` and ``topology``:
the master and K edge actors on the simulated network, every crypto op
through the coalescing queue, so same-tick ops of the K edges share one
launch.
"""
from __future__ import annotations

from portbench import program
from portbench.drivers.protocol import Driver as _Protocol


class Driver(_Protocol):
    def call(self, iters: int):
        from repro_torch.runtime import runner, topology
        cfg = program.protocol_config(self.config, seed=self.seed,
                                      iters=iters, device=self.device)
        return runner.run_on_runtime(
            self.A, self.y, cfg, mode=self.params["mode"],
            topology=topology.make(self.params["topology"], cfg.K))
