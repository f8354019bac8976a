"""A language model's train step through ``train.loop.make_train_step``,
steps back to back, judged against the plain reference that the
configuration names (``"reference": "lm"``: :mod:`portbench.reference.lm`,
the dense decoder; another family adds a module of its own there).

Set-up builds the program's train state once for the configuration file
(``loop.init_train_state``), puts the harness's own weights in it
(the reference's ``make_params``: one ``torch.Generator`` on the device,
seeded by ``--seed``), builds ``make_train_step`` and runs
``warmup_steps`` steps of the window's own call and feed: a fresh batch of
``batch`` x ``seq`` token ids each step, uniform over the vocabulary from
a generator on the device, the labels the ids shifted by one.  The
program gets only the batch.  The same object then runs the window: as
many steps as fill it at the warm-up's last step, each lapped on the
host clock after a device synchronize.

What the judge compares (read before the window): each warm-up step's
loss; the first step's gradient as the optimizer took it, leaf by leaf,
worked out from AdamW's first moment after one step (m = (1 - b1) g);
and each leaf's change over the warm-up steps (the parameters the window
starts from against the seed's).  After the window, with the program's
state freed, the reference trains the same weights on the same batches
in float32 and the judge takes each number's gap by the worst leaf.
Every window step's loss must be finite, and no step missing.
"""
from __future__ import annotations

import dataclasses
import importlib
import math
import statistics
import time

from portbench import program

#: this driver launches none of the program's hand-written kernels
BUILDS_KERNELS = False


def reference(config: dict):
    """The configuration's plain reference module."""
    return importlib.import_module(
        f"portbench.reference.{config['reference']}")


def model_config(config: dict):
    """The program's ``ModelConfig`` from the configuration file's keys."""
    from repro_torch.models.config import ModelConfig
    return ModelConfig(**{f.name: config[f.name]
                          for f in dataclasses.fields(ModelConfig)
                          if f.name in config})


def batches(config: dict, params: dict, seed: int, device: str):
    """The feed: an endless run of ``(tokens, labels)`` for one seed."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed((seed + 2 ** 62) % 2 ** 63)
    shape = (params["batch"], params["seq"] + 1)
    while True:
        ids = torch.randint(0, config["vocab"], shape, generator=gen,
                            device=device)
        yield ids[:, :-1], ids[:, 1:]


class Driver:
    def __init__(self, config: dict, params: dict, seed: int, device: str):
        self.config, self.params = config, params
        self.seed, self.device = seed, device
        self.feed = batches(config, params, seed, device)
        self.step_s = None

    def _sync(self) -> None:
        import torch
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()

    def _step(self, tokens, labels):
        self.state, met = self.step(self.state,
                                    {"tokens": tokens, "labels": labels})
        return met["loss"].detach()

    def setup(self) -> None:
        import torch
        from repro_torch.train import loop, optimizer
        opt = self.config["optimizer"]
        self.state = loop.init_train_state(model_config(self.config),
                                           self.seed, self.device)
        lm = reference(self.config)
        mine = lm.make_params(self.config, self.seed, self.device)
        load(self.state["params"], mine)
        del mine
        self.step = loop.make_train_step(
            model_config(self.config), optimizer.OptConfig(**opt),
            remat=self.config["remat"])
        self.warm = {"batches": [], "losses": []}
        for i in range(self.params["warmup_steps"]):
            tokens, labels = next(self.feed)
            self.warm["batches"].append((tokens.cpu(), labels.cpu()))
            t0 = time.perf_counter()
            loss = self._step(tokens, labels)
            self._sync()
            self.step_s = time.perf_counter() - t0
            self.warm["losses"].append(float(loss))
            if i == 0:
                self.warm["grad_norms"] = {
                    n: float(torch.linalg.vector_norm(m)) / (1 - opt["b1"])
                    for n, m in self.state["opt"]["m"].named_parameters()}
        with torch.no_grad():
            start = lm.make_params(self.config, self.seed, self.device)
            self.warm["change_norms"] = lm.change_norms(
                dict(self.state["params"].named_parameters()), start)
            del start

    def run(self, seconds: float, window) -> program.Outcome:
        steps = program.window_rounds(seconds, self.step_s,
                                      self.params["least_steps"])
        losses, laps = [], []
        with window.armed():
            window.open()
            t0 = window.t_open
            for _ in range(steps):
                losses.append(self._step(*next(self.feed)))
                self._sync()
                t1 = time.perf_counter()
                laps.append(t1 - t0)
                t0 = t1
            window.close()
        tokens = steps * self.params["batch"] * self.params["seq"]
        return program.Outcome(
            tenants=[], rounds=0, laps=laps, window_s=window.seconds,
            counts={"steps": steps, "tokens": tokens},
            payload=dict(self.warm, seed=self.seed, device=self.device,
                         steps=steps,
                         window_losses=[float(x) for x in losses]))


def load(params, mine: dict) -> None:
    """Copy the harness's weights into the program's parameters, which
    must hold the same leaves by name and shape."""
    import torch
    have = dict(params.named_parameters())
    shapes = {n: tuple(p.shape) for n, p in have.items()}
    want = {n: tuple(t.shape) for n, t in mine.items()}
    if shapes != want:
        odd = sorted(n for n in set(shapes) | set(want)
                     if shapes.get(n) != want.get(n))
        raise ValueError(f"the program's parameters and the reference's "
                         f"differ at {odd[:8]}")
    with torch.no_grad():
        for name, p in have.items():
            p.copy_(mine[name])


def reference_readings(config: dict, payload: dict, mm=None) -> dict:
    """The reference's losses, first gradient and change for the
    warm-up's batches, from the seed's weights, in float32 on the card
    (``mm``: another matrix product, the control's)."""
    import torch
    lm = reference(config)
    dev = payload["device"]
    params = lm.make_params(config, payload["seed"], dev)
    out = lm.follow(config, config["optimizer"], params,
                    [(t.to(dev), l.to(dev)) for t, l in payload["batches"]],
                    mm=mm or torch.matmul)
    start = lm.make_params(config, payload["seed"], dev)
    with torch.no_grad():
        out["change_norms"] = lm.change_norms(params, start)
    return out


def leaf_gap(got: dict, want: dict, leaves) -> float:
    """The worst leaf's gap between two norms, over the larger of the
    reference's norm of that leaf and of the median leaf."""
    floor = statistics.median(want.values())
    return max(abs(got[n] - want[n]) / max(want[n], floor) for n in leaves)


def compare(payload: dict, ref: dict, limits: dict) -> dict:
    """The numbers compared, each beside its limit, and the verdict."""
    gmed = statistics.median(ref["grad_norms"].values())
    moved = [n for n, g in ref["grad_norms"].items() if g >= 1e-3 * gmed]
    loss_gaps = [abs(a - b) / abs(b) if math.isfinite(a) else math.inf
                 for a, b in zip(payload["losses"], ref["losses"])]
    window = payload["window_losses"]
    values = {
        "loss_gap": max(loss_gaps),
        "grad_gap": leaf_gap(payload["grad_norms"], ref["grad_norms"],
                             ref["grad_norms"]),
        "change_gap": leaf_gap(payload["change_norms"],
                               ref["change_norms"], moved),
        "losses_nonfinite": sum(not math.isfinite(x) for x in window),
        "steps_missing": payload["steps"] - len(window),
    }
    values = {k: (v if v == v else math.inf) for k, v in values.items()}
    checks = {k: {"value": v, "limit": limits.get(k, 0)}
              for k, v in values.items()}
    over = {k for k, c in checks.items() if c["value"] > c["limit"]}
    warm = len(payload["losses"])
    failed_warm = warm if over & {"grad_gap", "change_gap"} else sum(
        g > limits["loss_gap"] for g in loss_gaps)
    return {"correct": not over, "attempted": warm + payload["steps"],
            "failed": failed_warm + values["losses_nonfinite"]
            + values["steps_missing"], "checks": checks}


def judge(outcome, config: dict) -> dict:
    verdict = compare(outcome.payload,
                      reference_readings(config, outcome.payload),
                      {k: v["limit"] for k, v in config["limits"].items()})
    verdict["inputs"] = {"model": config,
                         "seq": outcome.payload["batches"][0][0].shape[1]}
    return verdict
