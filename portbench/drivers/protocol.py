"""One job through ``core.protocol.run_protocol``, rounds back to back.

Set-up runs the entry once for ``warmup_rounds`` rounds at the cell's
shapes; the timed call then runs as many rounds as fill the window at the
warm-up's last round.  Its key generation, init and share phases are
set-up; the window is its iterate phase, timed on the host clock where
the program's phase clock laps.  A ``cipher`` among the traffic's
parameters takes the place of the configuration's.
"""
from __future__ import annotations

from portbench import program


class Driver:
    def __init__(self, config: dict, params: dict, seed: int, device: str):
        if "cipher" in params:
            config = {**config, "cipher": params["cipher"]}
        self.config, self.params = config, params
        self.seed, self.device = seed, device
        self.A, self.y = program.inputs(config, seed)
        self.round_s = None

    def call(self, iters: int):
        from repro_torch.core import protocol
        cfg = program.protocol_config(self.config, seed=self.seed,
                                      iters=iters, device=self.device)
        return protocol.run_protocol(self.A, self.y, cfg)

    def setup(self) -> None:
        res = self.call(self.params["warmup_rounds"])
        self.round_s = res.stats["seconds"]["rounds"][-1]

    def run(self, seconds: float, window) -> program.Outcome:
        rounds = program.window_rounds(seconds, self.round_s,
                                       self.params["least_rounds"])
        with window.armed(), window.phases(rounds):
            res = self.call(rounds)
        return program.Outcome(
            tenants=[program.Tenant(self.A, self.y, res.history)],
            rounds=rounds, laps=window.laps, window_s=window.seconds)
