"""Many tenants in one ``serve.protocol_engine.ProtocolEngine``.

``tenants`` protocol instances, tenant i with its own inputs and key
from seed + i, admitted together under ``admission``, each running every
round of the window; the engine fuses their same-shaped crypto ops
across tenants.  Set-up admits and runs the same tenants for
``warmup_rounds`` rounds in an engine of its own (the warm-up), then
admits the window's engine (key generation); the window is that engine's
``run()``, every tenant's init, share and rounds, and each tenant's
rounds are timed on the host clock where its phase clock laps.
"""
from __future__ import annotations

import statistics

from portbench import program


class Driver:
    def __init__(self, config: dict, params: dict, seed: int, device: str):
        self.config, self.params = config, params
        self.seed, self.device = seed, device
        self.inputs = [program.inputs(config, seed + i)
                       for i in range(params["tenants"])]
        self.round_s = None

    def engine(self, iters: int):
        from repro_torch.serve.protocol_engine import ProtocolEngine
        eng = ProtocolEngine(seed=self.seed,
                             admission=self.params["admission"])
        for i, (A, y) in enumerate(self.inputs):
            cfg = program.protocol_config(self.config, seed=self.seed + i,
                                          iters=iters, device=self.device)
            eng.admit(A, y, cfg, tid=f"t{i}", device=self.device)
        return eng

    def setup(self) -> None:
        eng = self.engine(self.params["warmup_rounds"])
        eng.run()
        # a fused round: the tenants' laps after their first
        laps = [ten.rt.clock.seconds["rounds"] for ten in eng.tenants.values()]
        self.round_s = statistics.median(
            lap for ten in laps for lap in (ten[1:] or ten))

    def run(self, seconds: float, window) -> program.Outcome:
        rounds = program.window_rounds(seconds, self.round_s,
                                       self.params["least_rounds"])
        eng = self.engine(rounds)
        with window.armed(), window.phases():
            window.open()
            results = eng.run()
            window.close()
        tenants = [program.Tenant(A, y, results[f"t{i}"].history)
                   for i, (A, y) in enumerate(self.inputs)]
        return program.Outcome(tenants=tenants, rounds=rounds,
                               laps=window.laps,
                               window_s=window.seconds,
                               serve=eng.collector.metrics_section())
